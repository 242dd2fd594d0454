"""The models behind the stages and the model zoo: the LMs of the RAG
``generate`` stage (layers and the decoder-only transformer, prefill and
decode against a KV cache), the learning-to-rank MLP of ``LTRRerank``,
GAT with its neighbour sampler, and the recsys models (``recsys``)."""
