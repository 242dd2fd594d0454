"""Top-k of batched score rows (replaces ``streaming_topk_pallas``)."""
