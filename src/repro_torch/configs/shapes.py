"""Canonical shape cells per family (``src/repro/configs/shapes.py``,
copied)."""
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

# — gat-cora: dataset-sized graph cells —
GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    # Reddit, fanout 15-10 from 1024 seeds -> padded subgraph:
    # nodes = 1024 + 1024*15 + 15360*10 ; edges = 15360 + 153600
    "minibatch_lg": dict(kind="train", n_nodes=169984, n_edges=168960,
                         d_feat=602, n_classes=41, sampled=True,
                         base_nodes=232965, base_edges=114615892,
                         batch_nodes=1024, fanouts=(15, 10)),
    "ogb_products": dict(kind="train", n_nodes=2449029, n_edges=61859140,
                         d_feat=100, n_classes=47),
    "molecule": dict(kind="train", n_graphs=128, nodes_per_graph=30,
                     edges_per_graph=64, d_feat=9, n_classes=2,
                     readout="mean"),
}

# — recsys —
RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, candidates=1000000),
}
