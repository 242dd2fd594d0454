"""The models behind the stages: the LMs of the RAG ``generate`` stage
(layers and the decoder-only transformer, prefill and decode against a KV
cache) and the learning-to-rank MLP of ``LTRRerank``."""
