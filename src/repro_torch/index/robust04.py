"""The TREC Robust04-scale collection of the paper's RQ1/RQ2 Experiments:
528,155 synthetic documents (vocab 200,000, mean length 300) and 250
topics in the T/TD/TDN forms (3/10/30 terms), made from fixed seeds as
``benchmarks/ir_bench.py`` makes them for the JAX package; and its dense
second stage at the configuration of ``bench_dense`` / ``bench_dense_pq``
there."""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.index.corpus import (ROBUST_DOCS, Topics, expand_topics,
                                      synthesize_corpus, synthesize_topics)
from repro_torch.index.dense import (build_dense_index, build_ivf_index,
                                     build_ivfpq_index)
from repro_torch.index.inverted import InvertedIndex, build_index

N_DOCS = ROBUST_DOCS
VOCAB = 200_000
MEAN_LEN = 300
N_TOPICS = 250
#: the dense configuration: dim 64 (``build_dense_index``'s default),
#: sqrt(D) coarse lists (``default_n_lists``) probed 8 at a time, PQ with
#: 16 subspaces and a shortlist 8x deeper than k
NPROBE = 8
PQ_M = 16
PQ_REFINE = 8


def robust04(device=None) -> tuple[InvertedIndex, dict[str, Topics], dict]:
    """Build the collection's index on ``device`` (the card by default)
    and its topics.  Returns (index, {"T", "TD", "TDN"} -> topics, info),
    where info holds the corpus's token count and the host seconds of the
    synthesis (``synth_s``) and of ``build_index`` (``build_s``)."""
    t0 = time.perf_counter()
    corpus = synthesize_corpus(N_DOCS, vocab=VOCAB, mean_len=MEAN_LEN, seed=0)
    topics_t = synthesize_topics(corpus, n_topics=N_TOPICS, q_len=3,
                                 rels_per_topic=30, seed=1)
    topics_td = expand_topics(topics_t, q_len=10, seed=2)
    topics_tdn = expand_topics(topics_td, q_len=30, seed=3)
    t1 = time.perf_counter()
    index = build_index(corpus, device=device)
    if index.doc_ids.is_cuda:
        torch.cuda.synchronize()
    info = {"tokens": int(corpus.doc_start[-1]), "synth_s": t1 - t0,
            "build_s": time.perf_counter() - t1}
    return index, {"T": topics_t, "TD": topics_td, "TDN": topics_tdn}, info


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize()


def robust04_dense(index: InvertedIndex):
    """The dense state over the collection's index, on its device: the
    embeddings, the IVF-flat index (list-ordered copy kept, for IVF-flat
    search) and the IVF-PQ index over the same coarse lists (codes, with
    exact re-scoring against the doc-ordered embeddings; it holds no
    list-ordered float copy).  Returns (dense, ivf, ivfpq, info), where
    info holds the seconds of each build: ``dense_s`` (on the device),
    ``ivf_s`` (k-means on the host, then the list-ordered copy) and
    ``pq_s`` (codebooks and codes on the host)."""
    t0 = time.perf_counter()
    dense = build_dense_index(index)
    _sync(dense.emb)
    t1 = time.perf_counter()
    ivf = build_ivf_index(dense)
    _sync(dense.emb)
    t2 = time.perf_counter()
    ivfpq = build_ivfpq_index(dense, m=PQ_M,
                              ivf=dataclasses.replace(ivf, emb=None))
    _sync(dense.emb)
    info = {"dense_s": t1 - t0, "ivf_s": t2 - t1,
            "pq_s": time.perf_counter() - t2}
    return dense, ivf, ivfpq, info
