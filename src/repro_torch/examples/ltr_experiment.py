"""Listing 1 of the paper, end to end: PRF candidates + multi-model
features + a trained LTR re-ranker, evaluated against the first-pass
baseline (the port of ``examples/ltr_experiment.py``).

    PYTHONPATH=src python -m repro_torch.examples.ltr_experiment \
        [--device cpu]

On the card the feature union runs on the fused-scoring kernel
(``fused_fat_retrieve``).
"""
import argparse

import numpy as np

from repro_torch.common import resolve_device
from repro_torch.core import (Experiment, Extract, LTRRerank, Retrieve,
                              RM3Expand, SDMRewrite, TorchBackend,
                              format_table)
from repro_torch.core.data import make_queries
from repro_torch.index import build_index, synthesize_corpus, \
    synthesize_topics


def run(device=None) -> dict:
    """The example on ``device`` (``None`` = the card); returns the
    Experiment's result, and the backend and the pipelines by name."""
    device = resolve_device(device)
    corpus = synthesize_corpus(n_docs=15_000, vocab=40_000, mean_len=150)
    train_topics = synthesize_topics(corpus, n_topics=24, q_len=3, seed=1)
    test_topics = synthesize_topics(corpus, n_topics=24, q_len=3, seed=2)
    index = build_index(corpus, device=device)
    backend = TorchBackend(index, default_k=50, device=device)

    Qtr = make_queries(np.asarray(train_topics.terms),
                       np.asarray(train_topics.weights),
                       np.asarray(train_topics.qids),
                       device=device)
    Qte = make_queries(np.asarray(test_topics.terms),
                       np.asarray(test_topics.weights),
                       np.asarray(test_topics.qids),
                       device=device)

    # Listing 1 structure (adapted): first pass, PRF, sdm, features -> LTR
    first_pass = Retrieve("BM25", k=50)
    prf = first_pass >> RM3Expand(fb_docs=5, fb_terms=8) >> \
        Retrieve("BM25", k=50)
    sdm = SDMRewrite() >> Retrieve("BM25", k=50)
    features = prf >> (Extract("QL") ** Extract("TF_IDF") ** Extract("DPH"))
    full_pipeline = features >> LTRRerank(n_features=3, epochs=40)

    # train the pipeline (fit propagates to the LTR stage, paper eq. 9)
    full_pipeline.fit(Qtr, train_topics.qrels, backend=backend)

    res = Experiment(
        [first_pass, prf, sdm, full_pipeline],
        Qte, test_topics.qrels, ["map", "ndcg_cut_10", "P_10"],
        backend=backend,
        names=["bm25", "bm25+rm3", "sdm>>bm25", "full (ltr)"],
        measure_time=True)
    print(format_table(res["table"]))
    return {"result": res, "backend": backend, "pipelines": {
        "bm25": first_pass, "bm25+rm3": prf, "sdm>>bm25": sdm,
        "full (ltr)": full_pipeline}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda)")
    run(ap.parse_args().device)


if __name__ == "__main__":
    main()
