"""The LMs of the RAG ``generate`` stage: layers and the decoder-only
transformer (prefill and decode against a KV cache)."""
