"""Host-side CSR neighbour sampler (GraphSAGE-style fanout sampling); the
port of ``src/repro/models/sampler.py``, numpy copied as it is.

``minibatch_lg`` (Reddit-scale: 232,965 nodes / 114.6M edges, fanout 15-10)
requires a *real* sampler: we build a CSR adjacency once (numpy) and sample
k-hop neighbourhoods per minibatch, emitting fixed-size padded subgraphs so
the jitted train step sees static shapes.

Layout of a sampled subgraph for fanouts [f1, f2] and B seed nodes:
  layer-0 nodes: B seeds
  layer-1 nodes: B*f1 sampled neighbours (padded w/ self-loops)
  layer-2 nodes: B*f1*f2
Edges connect consecutive layers (child -> parent), giving
E = B*f1 + B*f1*f2 edges; node features are gathered on host.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # [N+1] int64
    indices: np.ndarray  # [E] int32
    features: np.ndarray  # [N, d] float32 (may be memory-mapped)
    labels: np.ndarray   # [N] int32

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1


def random_graph(n_nodes: int, avg_degree: int, d_feat: int, n_classes: int,
                 seed: int = 0) -> CSRGraph:
    """Synthesise a power-law-ish random graph in CSR form."""
    rng = np.random.default_rng(seed)
    # degree ~ clipped zipf around avg_degree
    deg = np.minimum(rng.zipf(1.7, n_nodes) + avg_degree // 2, 16 * avg_degree)
    deg = (deg * (avg_degree / max(deg.mean(), 1))).astype(np.int64)
    deg = np.maximum(deg, 1)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n_nodes, indptr[-1], dtype=np.int32)
    feats = rng.standard_normal((n_nodes, d_feat), dtype=np.float32)
    labels = rng.integers(0, n_classes, n_nodes, dtype=np.int32)
    return CSRGraph(indptr, indices, feats, labels)


class NeighborSampler:
    def __init__(self, graph: CSRGraph, fanouts: list[int], seed: int = 0):
        self.g = graph
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """For each node pick ``fanout`` neighbours (with replacement;
        isolated nodes self-loop). Returns [len(nodes), fanout] int32."""
        g = self.g
        starts = g.indptr[nodes]
        degs = g.indptr[nodes + 1] - starts
        # random offsets into each adjacency row
        offs = (self.rng.random((nodes.shape[0], fanout)) *
                np.maximum(degs, 1)[:, None]).astype(np.int64)
        picked = g.indices[np.minimum(starts[:, None] + offs,
                                      g.indptr[-1] - 1)].astype(np.int32)
        return np.where(degs[:, None] > 0, picked, nodes[:, None].astype(np.int32))

    def sample(self, seeds: np.ndarray) -> dict[str, np.ndarray]:
        """Sample the k-hop padded subgraph for ``seeds`` [B]."""
        layers = [seeds.astype(np.int32)]
        src_l, dst_l = [], []
        offset = 0
        for fanout in self.fanouts:
            parents = layers[-1]
            children = self._sample_neighbors(parents, fanout).reshape(-1)
            child_off = offset + parents.shape[0]
            # edges: child -> parent (messages flow to the seed side)
            src = child_off + np.arange(children.shape[0], dtype=np.int32)
            dst = offset + np.repeat(np.arange(parents.shape[0], dtype=np.int32), fanout)
            src_l.append(src)
            dst_l.append(dst)
            layers.append(children)
            offset = child_off
        nodes = np.concatenate(layers)
        return {
            "x": self.g.features[nodes],
            "src": np.concatenate(src_l),
            "dst": np.concatenate(dst_l),
            "labels": np.where(
                np.arange(nodes.shape[0]) < seeds.shape[0],
                self.g.labels[nodes], 0).astype(np.int32),
            "label_mask": (np.arange(nodes.shape[0]) < seeds.shape[0]),
        }

    def batches(self, batch_size: int, n_batches: int):
        for _ in range(n_batches):
            seeds = self.rng.integers(0, self.g.n_nodes, batch_size, dtype=np.int64)
            yield self.sample(seeds)


def pack_molecule_batch(rng: np.random.Generator, n_graphs: int, n_nodes: int,
                        n_edges: int, d_feat: int, n_classes: int):
    """Pack ``n_graphs`` disjoint small graphs into one padded super-graph."""
    N = n_graphs * n_nodes
    src = np.concatenate([
        rng.integers(0, n_nodes, n_edges, dtype=np.int32) + g * n_nodes
        for g in range(n_graphs)])
    dst = np.concatenate([
        rng.integers(0, n_nodes, n_edges, dtype=np.int32) + g * n_nodes
        for g in range(n_graphs)])
    return {
        "x": rng.standard_normal((N, d_feat), dtype=np.float32),
        "src": src,
        "dst": dst,
        "graph_ids": np.repeat(np.arange(n_graphs, dtype=np.int32), n_nodes),
        "node_counts": np.full((n_graphs,), n_nodes, np.int32),
        "labels": rng.integers(0, n_classes, n_graphs, dtype=np.int32),
    }
