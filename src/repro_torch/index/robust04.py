"""The TREC Robust04-scale collection of the paper's RQ1/RQ2 Experiments:
528,155 synthetic documents (vocab 200,000, mean length 300) and 250
topics in the T/TD/TDN forms (3/10/30 terms), made from fixed seeds as
``benchmarks/ir_bench.py`` makes them for the JAX package."""
from __future__ import annotations

import time

import torch

from repro_torch.index.corpus import (ROBUST_DOCS, Topics, expand_topics,
                                      synthesize_corpus, synthesize_topics)
from repro_torch.index.inverted import InvertedIndex, build_index

N_DOCS = ROBUST_DOCS
VOCAB = 200_000
MEAN_LEN = 300
N_TOPICS = 250


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
