"""Canonical shape cells of the LM family (``LM_SHAPES`` of
``src/repro/configs/shapes.py``, copied; the GNN and recsys cells come
with the model zoo, ROADMAP §1 item 3)."""
from __future__ import annotations

# — LM-family transformers: seq_len × global_batch —
LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", kv_len=32768, batch=128),
    # long-context decode: 1 new token vs a 512k KV cache (linear per step;
    # KV is sequence-sharded — see DESIGN.md §Shape-cell notes)
    "long_500k": dict(kind="decode", kv_len=524288, batch=1),
}
