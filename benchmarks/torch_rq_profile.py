#!/usr/bin/env python3
"""Where the time goes on the card: a ``torch.profiler`` breakdown of the
port's RQ1/RQ2 paths, of cell L1's RM3, linear-fusion and
learning-to-rank pipelines (and the LTR stage's fit), of its dense second stage (brute-force and
IVF-PQ DenseRetrieve) at TREC Robust04 scale (528,155 documents), and of
the RAG answer stage's LMs (cell G1: Qwen2-1.5B; the MoE cells G2,
OLMoE-1B-7B, and G3, Llama-4-Scout at 8 layers; random weights from seed
0), eagerly and as captured CUDA graphs, with an MoE layer's time split
into router, dispatch, expert products and combine, and of the served
path (cell S1: a burst of single-query requests, and RAG requests through
the decode pool).

Run from the repository root on a machine with one NVIDIA H100:

    python3 benchmarks/torch_rq_profile.py

It builds the Robust04-scale index and its dense state on the card
(``repro_torch.index.robust04``), warms every pipeline up once, then
profiles one timed run of each setting over the 250 T topics (chunks of
16), and for G1 the prefill of one chunk of 16 prompts of 1,024 tokens
and its 31 greedy decode steps apart (the steps also as one captured
graph), then a ``MultiPipelineServer`` (the engine's default ladder, the
stage cache off so that each run executes): 250 T topics as single-query
requests to ``Retrieve("BM25", k=100) >> Extract("QL")``, and 16 to G1's
pipeline decoded in a pool of 8 slots; then for G2 (chunks of 16 prompts
of 1,024 tokens) and G3 (chunks of 4 prompts of 16,384) the first chunk's
prefill and its decode steps as one captured graph, and layer 0's MoE
split into its parts by CUDA events; and prints, per setting:
the wall time, the device time summed over kernels, the device's idle
share of the wall time, the operators with the most device time, and the
port's own kernels whatever their rank.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORM = "T"
TOP = 12
#: device names of the port's hand-written kernels (csrc/*.cu)
PORT_KERNELS = ("topk_segments_kernel", "topk_merge_kernel",
                "fused_scoring_kernel", "dense_segments_kernel",
                "pq_cluster_kernel", "flash_attention_kernel")
#: cell G1: prompt length, greedy tokens, documents per prompt
G1_PROMPT, G1_NEW, G1_DOCS = 1024, 32, 4
#: the MoE cells: name -> (config module, layers kept or None, chunk,
#: prompt length, documents per prompt, reranked depth); 32 greedy tokens
MOE_CELLS = {"G2": ("olmoe_1b_7b", None, 16, 1024, 4, 8),
             "G3": ("llama4_scout_17b_a16e", 8, 4, 16384, 64, 64)}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profile(name: str, run) -> None:
    """Warm ``run`` up once, then profile one call of it and print the
    wall time, the device time, the idle share and the top operators."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()                                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side events only: a CPU operator also reports the device
    # time of the kernels it launched, which would count it twice
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    dev_us = sum(_device_us(e) for e in evts)
    idle = 1.0 - dev_us / wall_us if wall_us else float("nan")
    print(f"== {name}: wall {wall_us / 1e3:.3f} ms, device "
          f"{dev_us / 1e3:.3f} ms, device idle share {idle:.3f}")
    ranked = sorted(evts, key=_device_us, reverse=True)
    for rank, e in enumerate(ranked):
        if rank < TOP or any(k in e.key for k in PORT_KERNELS):
            print(f"   {rank + 1:3d}. {_device_us(e) / 1e3:10.3f} ms  "
                  f"{e.count:6d} calls  {e.key[:90]}")


def _profile_g1(index, dense, Q):
    """G1's LM on one chunk of 16 T topics: the prefill, then the decode
    steps (eagerly, and as one captured graph), each profiled apart;
    returns (cfg, lm)."""
    import dataclasses
    import torch
    import repro_torch as rt
    from repro_torch.configs import qwen2_1_5b
    from repro_torch.core import Context, StageProgram
    from repro_torch.models import transformer_lm as tlm
    cfg = dataclasses.replace(qwen2_1_5b.model_cfg(), attn_impl="pallas")
    be = rt.TorchBackend(index, dense, default_k=1000, bucket_ladder=(16,),
                         device="cuda")
    be.register_lm(cfg.name, cfg, seed=0)
    lm = be.lm(cfg.name)[1]
    Q16 = {k: v[:16] for k, v in Q.items()}
    R = rt.run_pipeline(rt.Retrieve("BM25") >> rt.DenseRerank() % 8, Q16,
                        backend=be)
    gen = rt.Generate(cfg.name, max_new_tokens=G1_NEW,
                      max_prompt_len=G1_PROMPT, prompt_docs=G1_DOCS)
    prompts = gen.assemble(Context(be), Q16, R)
    cache = tlm.init_kv_cache(cfg, 16, G1_PROMPT + G1_NEW, device="cuda")
    logits, _ = tlm.prefill(cfg, lm, prompts, cache)
    first = torch.argmax(logits, -1)[:, None]

    def decode():
        tok = first
        for t in range(G1_NEW - 1):
            out, _ = tlm.decode_step(cfg, lm, tok, cache, G1_PROMPT + t)
            tok = torch.argmax(out, -1)[:, None]

    def decode_all(lm, tok, cache):
        for t in range(G1_NEW - 1):
            out, cache = tlm.decode_step(cfg, lm, tok, cache, G1_PROMPT + t)
            tok = torch.argmax(out, -1)[:, None]
        return tok, cache

    prog = StageProgram(key=("g1 decode steps",), fn=decode_all)
    _profile(f"G1 prefill (16 x {G1_PROMPT} tokens, {cfg.name})",
             lambda: tlm.prefill(cfg, lm, prompts, cache))
    _profile(f"G1 decode ({G1_NEW - 1} steps of 16 tokens)", decode)
    _profile(f"G1 decode, one captured graph ({G1_NEW - 1} steps)",
             lambda: be.engine.run_pinned(prog, lm, first, cache,
                                          donate_argnums=(2,)))
    return cfg, lm


def _events_ms(fn, reps: int = 5) -> float:
    """Mean device ms of ``fn()`` by CUDA events, after one warm-up."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _moe_parts(name: str, p, x, m) -> None:
    """One MoE layer's device time split into its parts, at the hidden
    states ``x`` [B, S, d] of a prefill or a decode step (CUDA events,
    each part on its own inputs): the router (logits, top-k, aux), the
    dispatch (positions and the [E, C, d] buffer), the expert products,
    the combine (rows back, gates, sum over k) and the shared expert."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    C = moe.scatter_capacity(m, B * S)
    gates, idx, _ = moe._routing(xt, p.router, m)
    flat_e, slot, keep = moe.scatter_slots(idx, m.n_experts, C)
    buf = moe._scatter_buffer(xt, flat_e, slot, keep, m.n_experts, C)
    y = moe._expert_ffn(p, buf)

    def dispatch():
        f, s, k = moe.scatter_slots(idx, m.n_experts, C)
        return moe._scatter_buffer(xt, f, s, k, m.n_experts, C)

    parts = {"router": lambda: moe._routing(xt, p.router, m),
             "dispatch": dispatch,
             "experts": lambda: moe._expert_ffn(p, buf),
             "combine": lambda: moe._scatter_combine(y, flat_e, slot, keep,
                                                     gates)}
    if m.n_shared:
        parts["shared expert"] = lambda: L.mlp_apply(p.shared, x)
    ms = {k: _events_ms(f) for k, f in parts.items()}
    whole = _events_ms(lambda: moe.moe_apply(p, x, m))
    print(f"   {name}: one MoE layer, x {tuple(x.shape)}, capacity {C}: "
          f"whole {whole:.3f} ms; " + ", ".join(
              f"{k} {v:.3f} ms ({v / sum(ms.values()):.3f})"
              for k, v in ms.items()))


def _profile_moe(index, dense, Q, cell: str) -> None:
    """An MoE cell's LM on its first chunk of T topics (random weights
    from seed 0, bf16, the flash kernel): the prefill, then the 31 greedy
    decode steps as one captured graph, each profiled apart; and layer
    0's MoE split into its parts at the prefill's and a step's inputs."""
    import dataclasses
    import importlib
    import torch
    import repro_torch as rt
    from repro_torch.core import Context, StageProgram
    from repro_torch.models import layers as L
    from repro_torch.models import transformer_lm as tlm
    mod, layers, chunk, prompt, docs, depth = MOE_CELLS[cell]
    full = importlib.import_module(f"repro_torch.configs.{mod}").model_cfg()
    cfg = dataclasses.replace(full, attn_impl="pallas",
                              n_layers=layers or full.n_layers)
    be = rt.TorchBackend(index, dense, default_k=1000,
                         bucket_ladder=(chunk,), device="cuda")
    be.register_lm(cfg.name, cfg, seed=0)
    lm = be.lm(cfg.name)[1]
    Qc = {k: v[:chunk] for k, v in Q.items()}
    R = rt.run_pipeline(rt.Retrieve("BM25") >> rt.DenseRerank() % depth, Qc,
                        backend=be)
    gen = rt.Generate(cfg.name, max_new_tokens=G1_NEW, max_prompt_len=prompt,
                      prompt_docs=docs)
    prompts = gen.assemble(Context(be), Qc, R)
    cache = tlm.init_kv_cache(cfg, chunk, prompt + G1_NEW, device="cuda")
    logits, _ = tlm.prefill(cfg, lm, prompts, cache)
    first = torch.argmax(logits, -1)[:, None]
    del logits

    def decode_all(lm, tok, cache):
        for t in range(G1_NEW - 1):
            out, cache = tlm.decode_step(cfg, lm, tok, cache, prompt + t)
            tok = torch.argmax(out, -1)[:, None]
        return tok, cache

    prog = StageProgram(key=(cell, "decode steps"), fn=decode_all)
    _profile(f"{cell} prefill ({chunk} x {prompt} tokens, {cfg.name}, "
             f"{cfg.n_layers} layers)",
             lambda: tlm.prefill(cfg, lm, prompts, cache))
    _profile(f"{cell} decode, one captured graph ({G1_NEW - 1} steps of "
             f"{chunk} tokens)",
             lambda: be.engine.run_pinned(prog, lm, first, cache,
                                          donate_argnums=(2,)))
    blk = lm.layers[0]
    h = L.rmsnorm(lm.embed[prompts.long()], blk.ln_mlp, cfg.norm_eps)
    _moe_parts(f"{cell} prefill", blk.moe, h, cfg.moe)
    _moe_parts(f"{cell} decode step", blk.moe, h[:, :1].contiguous(),
               cfg.moe)


def _profile_serve(index, dense, Q, cfg, lm) -> None:
    """Cell S1's served path, the stage cache off: a burst of 250
    single-query requests to one tenant, then 16 RAG requests through the
    decode pool (slot prefills and ragged steps, each a captured graph)."""
    import repro_torch as rt
    be = rt.TorchBackend(index, dense, default_k=1000, device="cuda")
    be.register_lm(cfg.name, cfg, lm)
    gen = rt.Generate(cfg.name, max_new_tokens=G1_NEW,
                      max_prompt_len=G1_PROMPT, prompt_docs=G1_DOCS)
    server = rt.MultiPipelineServer(
        {"ql": rt.Retrieve("BM25", k=100) >> rt.Extract("QL")}, be,
        rt.ServeConfig.default(optimize=False, cache_entries=0,
                               max_queue=4096).with_decode(8))
    server.add_pipeline(rt.Retrieve("BM25") >> rt.DenseRerank() % 8 >> gen,
                        name="rag", optimize=True)
    server.warmup({k: v[:1] for k, v in Q.items()})

    def serve(name, n):
        server.submit({k: v[:n] for k, v in Q.items()}, pipeline=name)
        server.pump()

    nq = int(Q["qid"].shape[0])
    _profile(f"S1 served burst ({nq} requests, Retrieve k=100 >> Extract "
             f"QL, ladder {be.engine.ladder})", lambda: serve("ql", nq))
    _profile("S1 served RAG (16 requests, 8 slots, slot prefill + ragged "
             "decode steps as captured graphs)", lambda: serve("rag", 16))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_rq_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch.common import card
    from repro_torch.core import BackendDescriptor
    from repro_torch.index.robust04 import (NPROBE, PQ_M, PQ_REFINE,
                                            robust04, robust04_dense)

    index, forms, _ = robust04(device="cuda")
    dense, ivf, ivfpq, _ = robust04_dense(index)
    topics = forms[FORM]
    Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                        device="cuda")
    rq1 = rt.Retrieve("BM25") % 10
    rq2 = (rt.Retrieve("BM25") >> (rt.Extract("QL") **
                                   rt.Extract("TF_IDF"))) % 1000
    kernels = BackendDescriptor.default({"fat", "fused_topk",
                                         "fused_scoring"})
    d2 = rt.DenseRetrieve(k=10, nprobe=0) % 10
    d4 = rt.DenseRetrieve(k=10, nprobe=NPROBE, pq=True) % 10
    flat = dict(ivf=ivf)
    pq = dict(ivfpq=ivfpq, pq_m=PQ_M, pq_refine=PQ_REFINE)
    bm25 = rt.Retrieve("BM25")
    prf = bm25 >> rt.RM3Expand(fb_docs=10, fb_terms=10) >> rt.Retrieve("BM25")
    ltr_stage = rt.LTRRerank(n_features=3, epochs=30)
    ltr = ((rt.Retrieve("BM25") >> (rt.Extract("QL") ** rt.Extract("TF_IDF")
                                    ** rt.Extract("DPH"))) % 1000
           >> ltr_stage)
    runs = [("rq1 unoptimised", rq1, None, False, {}),
            ("rq1 kernels", rq1, kernels, True, {}),
            ("rq1 full (pruned)", rq1, None, True, {}),
            ("rq2 unoptimised", rq2, None, False, {}),
            ("rq2 optimised", rq2, None, True, {}),
            ("L1 prf (bm25 >> RM3 >> bm25)", prf, None, True, {}),
            ("L1 fusion (0.7 BM25 + 0.3 QL -> multi_retrieve)",
             (0.7 * bm25 + 0.3 * rt.Retrieve("QL")) % 1000, None, True, {}),
            ("L1 ltr (fused_fat_retrieve >> LTRRerank)", ltr, None, True,
             {}),
            ("D2 brute force unoptimised", d2, None, False, flat),
            ("D2 brute force optimised", d2, None, True, flat),
            ("D4 IVF-PQ unoptimised", d4, None, False, pq),
            ("D4 IVF-PQ optimised", d4, None, True, pq)]
    for name, pipe, desc, opt, dense_kw in runs:
        be = rt.TorchBackend(index, dense, default_k=1000,
                             bucket_ladder=(16,), descriptor=desc,
                             device="cuda", **dense_kw)
        node = rt.compile_pipeline(pipe, be) if opt else pipe
        _profile(f"{name} ({FORM}, {len(topics.qids)} topics)",
                 lambda: rt.run_pipeline(node, Q, backend=be, optimize=False))
    # the LTR stage's fit on the 125 training topics of cell L1 (the
    # uncompiled feature pipeline, then 30 full-batch steps on the
    # [125, 1000, 1000] pairs)
    from repro_torch.core import tuning
    train, _ = next(tuning.kfold_splits(topics.qids, 2, seed=0))
    Qtr = tuning._subset(Q, train)
    qrels_tr = tuning._subset_qrels(topics.qrels, Qtr)
    be = rt.TorchBackend(index, default_k=1000, bucket_ladder=(16,),
                         device="cuda")
    _profile(f"L1 ltr fit ({len(train)} topics, 30 epochs)",
             lambda: ltr.fit(Qtr, qrels_tr, backend=be))
    cfg, lm = _profile_g1(index, dense, Q)
    _profile_serve(index, dense, Q, cfg, lm)
    del cfg, lm
    for cell in MOE_CELLS:
        torch.cuda.empty_cache()
        _profile_moe(index, dense, Q, cell)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
