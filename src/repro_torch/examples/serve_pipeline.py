"""Serving example: the same declarative pipeline run two ways — as an
offline Experiment, then as a long-lived online service through
``PipelineServer`` (continuous micro-batching over the compiled pipeline)
configured with ``ServeConfig`` builders, multiplexing a second tenant
pipeline over the same engine/scheduler/stage-cache (WFQ lanes, shared
prefix hits), plus a full RAG chain — ``retrieve >> rerank % k >>
generate`` — served with token-level continuous batching (the port of
``examples/serve_pipeline.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_pipeline \
        [--device cpu]

On the card the ``DenseRerank`` runs on the dense-scoring kernel
(``fused_dense_rerank``).
"""
import argparse
import time

import numpy as np

from repro_torch.common import resolve_device
from repro_torch import (DenseRerank, Experiment, Generate, PipelineServer,
                         Retrieve, ServeConfig, TorchBackend, format_table,
                         make_queries)
from repro_torch.index import build_index, synthesize_corpus, \
    synthesize_topics
from repro_torch.models import transformer_lm as tlm


def run(device=None) -> dict:
    """The example on ``device`` (``None`` = the card); returns the
    Experiment's result, the served results and RAG answers, both servers'
    stats, and the backend and the pipelines by name."""
    device = resolve_device(device)
    # --- retrieval side -----------------------------------------------------
    corpus = synthesize_corpus(n_docs=10_000, vocab=30_000, mean_len=120)
    topics = synthesize_topics(corpus, n_topics=12, q_len=3)
    index = build_index(corpus, device=device)
    backend = TorchBackend(index, default_k=50, device=device)
    Q = make_queries(np.asarray(topics.terms), np.asarray(topics.weights),
                     np.asarray(topics.qids), device=device)

    pipe = (Retrieve("BM25") % 20) >> DenseRerank(alpha=0.3)
    res = Experiment([Retrieve("BM25") % 20, pipe], Q, topics.qrels,
                     ["map", "ndcg_cut_10"], backend=backend,
                     names=["bm25@20", "bm25>>dense"], measure_time=True)
    print(format_table(res["table"]))

    # --- the same pipeline as a multi-tenant online service -----------------
    cfg = (ServeConfig.default()
           .with_batching(max_wait_ms=4.0)
           .with_lanes(("interactive", 4.0), ("background", 1.0),
                       default="interactive"))
    server = PipelineServer(pipe, backend, cfg, name="dense")
    server.add_pipeline(Retrieve("BM25") % 20, name="bm25")  # second tenant:
    server.warmup(Q)       # compile every (stage, bucket) pair, per tenant
    server.start()         # shares the dense tenant's BM25 prefix via cache
    reqs = []
    for i in range(24):                  # queries arrive one at a time
        row = {k: v[i % 12:i % 12 + 1] for k, v in Q.items()}
        tenant = "dense" if i < 12 else "bm25"
        reqs.append(server.submit_one(
            row, pipeline=tenant,
            lane="interactive" if tenant == "dense" else "background"))
        time.sleep(0.002)
    results = [r.wait(timeout=30) for r in reqs]
    server.stop()
    s = server.stats()
    print(f"\nserved {s['served']} queries in {s['batches']} micro-batches "
          f"(mean batch {s['mean_batch_size']}); "
          f"p50={s['latency_ms']['p50_ms']}ms "
          f"p95={s['latency_ms']['p95_ms']}ms; "
          f"cache hit depths {s['cache_hit_depths']}; "
          f"cross-pipeline prefix hits: {s['cross_pipeline_hits']}; "
          f"lane slots {s['lane_served']}; "
          f"recompiles after warmup: {s['recompiles_since_warmup']}")
    top = np.asarray(results[0]["docids"])[0, :5]
    print(f"rid=1 top-5 docids: {top}")

    # --- RAG: the same retrieval prefix feeding a generate leaf -------------
    # Generate is a typed IR stage (R -> A, terminal): the retrieval prefix
    # rides the bucketed micro-batches above while prompts decode in a
    # continuous-batched slot pool, new requests admitted between decode
    # steps.  All decode shapes are pinned in the engine's program cache,
    # so the zero-recompile invariant covers generation too.
    lm_cfg = tlm.LMConfig(name="serve-demo", n_layers=2, d_model=64, n_q=4,
                          n_kv=2, d_head=16, d_ff=128, vocab=512)
    backend.register_lm(lm_cfg.name, lm_cfg)
    rag = (pipe % 8 >> Generate(lm_cfg.name, max_new_tokens=8,
                                max_prompt_len=48, prompt_docs=3))
    rag_server = PipelineServer(
        rag, backend, ServeConfig.default().with_decode(4))
    rag_server.warmup(Q)
    rag_reqs = [rag_server.submit_one(
        {k: v[i:i + 1] for k, v in Q.items()})
        for i in range(12)]
    rag_server.pump()
    answers = [r.wait(30) for r in rag_reqs]
    rs = rag_server.stats()
    print(f"\nserved {rs['decode']['requests']} RAG requests "
          f"({rs['decode']['tokens']} tokens) through "
          f"{rs['decode_pools']['default']['slots']} decode slots in "
          f"{rs['decode_pools']['default']['decode_steps']} decode steps; "
          f"ttft p95={rs['decode']['ttft_ms']['p95_ms']}ms, "
          f"per-token p95={rs['decode']['per_token_ms']['p95_ms']}ms; "
          f"recompiles after warmup: {rs['recompiles_since_warmup']}")
    print(f"rid=0 answer tokens: "
          f"{np.asarray(answers[0]['tokens'])[0].tolist()}")
    return {"result": res, "results": results, "top5": top,
            "answers": answers, "stats": s, "rag_stats": rs,
            "backend": backend, "pipelines": {
                "bm25@20": Retrieve("BM25") % 20, "bm25>>dense": pipe,
                "rag": rag}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda)")
    run(ap.parse_args().device)


if __name__ == "__main__":
    main()
