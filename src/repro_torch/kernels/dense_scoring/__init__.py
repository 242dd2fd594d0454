"""Dense scoring fused with top-k (replaces ``dense_topk_pallas``)."""
