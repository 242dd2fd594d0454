"""Quickstart: declarative IR pipelines, rewriting, and evaluation (the
port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Mirrors the paper's core flow: declare pipelines with operators, let the
compiler rewrite them against the backend's capabilities, evaluate
side-by-side with Experiment.  On the card ``bm25 % 100`` runs on the
top-k kernel (``fused_topk_retrieve``).
"""
import argparse

import numpy as np

from repro_torch.common import resolve_device
from repro_torch.core import (Experiment, Retrieve, RM3Expand, TorchBackend,
                              Extract, compile_pipeline, format_table,
                              raise_ir)
from repro_torch.core.data import make_queries
from repro_torch.index import build_index, synthesize_corpus, \
    synthesize_topics


def run(device=None) -> dict:
    """The example on ``device`` (``None`` = the card); returns each
    pipeline's rewrite trace, the IR listing, the Experiment's result, and
    the backend and the Experiment's pipelines by name."""
    device = resolve_device(device)
    # 1. a (synthetic) test collection + inverted index on the device
    corpus = synthesize_corpus(n_docs=20_000, vocab=50_000, mean_len=150)
    topics = synthesize_topics(corpus, n_topics=25, q_len=3)
    index = build_index(corpus, device=device)
    backend = TorchBackend(index, default_k=100, device=device)
    Q = make_queries(np.asarray(topics.terms), np.asarray(topics.weights),
                     np.asarray(topics.qids), device=device)

    # 2. declare pipelines with the operator algebra (paper Table 2)
    bm25 = Retrieve("BM25")
    top10 = bm25 % 10                                   # rank cutoff
    fusion = 0.7 * Retrieve("BM25", k=100) + 0.3 * Retrieve("QL", k=100)
    prf = Retrieve("BM25", k=100) >> RM3Expand() >> Retrieve("BM25", k=100)
    fat = Retrieve("BM25", k=100) >> (Extract("QL") ** Extract("TF_IDF"))

    # 3. the compiler rewrites them against backend capabilities
    traces = {}
    for name, pipe in [("cutoff", top10), ("fusion", fusion), ("fat", fat)]:
        trace = []
        opt = raise_ir(compile_pipeline(pipe, backend, trace=trace))
        traces[name] = [t[0] for t in trace]
        print(f"{name:8s} {pipe!r}\n     -->  {opt!r}"
              f"   (rules: {traces[name]})")

    # 3b. or inspect the full compiler pipeline: typed IR before/after
    # each pass (schemas, rewrites, the cost-gated kernel lowering)
    print()
    listing = top10.explain(backend)
    print(listing)

    # 4. evaluate side-by-side (common topics/qrels, shared prefix cache)
    res = Experiment(
        [bm25 % 100, fusion, prf],
        Q, topics.qrels, ["map", "ndcg_cut_10", "P_10"],
        backend=backend, names=["bm25", "fusion", "bm25+rm3"],
        measure_time=True)
    print()
    print(format_table(res["table"]))
    return {"traces": traces, "explain": listing, "result": res,
            "backend": backend, "pipelines": {
                "bm25": bm25 % 100, "fusion": fusion, "bm25+rm3": prf}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda)")
    run(ap.parse_args().device)


if __name__ == "__main__":
    main()
