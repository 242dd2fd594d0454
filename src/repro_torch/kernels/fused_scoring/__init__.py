"""Single-pass multi-model postings scoring (replaces ``fused_scoring_pallas``)."""
