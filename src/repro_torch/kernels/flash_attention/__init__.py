"""Causal GQA flash attention of the LM prefill (replaces
``flash_attention_pallas``)."""
