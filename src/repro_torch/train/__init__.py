"""Training substrate (the port of ``src/repro/train``): AdamW, the train
step with gradient accumulation, the deterministic data pipeline,
checkpoints in the JAX package's on-disk format, gradient compression and
fault tolerance."""
