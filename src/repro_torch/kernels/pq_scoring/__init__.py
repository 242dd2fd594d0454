"""PQ/ADC scoring fused with top-k (replaces ``pq_topk_pallas``)."""
