#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc``, times an empty
launch (the floor printed beside each kernel's time), builds the TREC
Robust04-scale index (528,155 documents) on the card, holds each kernel
against its plain PyTorch version at the main path's shapes, runs the
paper's RQ1 (``Retrieve("BM25") % 10``) and RQ2 (``Retrieve >> (Extract **
Extract) % 1000``) Experiments for the T/TD/TDN topic formulations, then
builds the dense second stage (embeddings, IVF-flat, IVF-PQ) and runs its
four pipelines — BM25 >> DenseRerank, brute-force, IVF-flat and IVF-PQ
DenseRetrieve, each % 10 — unoptimised and optimised on the T topics (and
D4 once more on the host, whose ranking the card's must equal), then
holds the flash-attention kernels against their plain version (and times
the bf16 one beside the library call at shapes around G1's) and runs the
RAG answer stage at full width (cell G1: ``Retrieve("BM25") >>
DenseRerank() % 8 >> Generate(...)`` with Qwen2-1.5B, 28 layers, random
weights from seed 0, 1,024-token prompts and 32 greedy tokens on the 250 T
topics, the greedy decode of each chunk one captured CUDA graph), then
serves cell S1 (four tenants on one server: two sharing a BM25 prefix in
the stage cache, a top-10 on the top-k kernel and G1's RAG pipeline in a
continuous-batching decode pool of captured graphs), and shows through the
kernels' launch counters that each main path ran on its kernels.  Beside
the main path it runs cell A1 (the measured optimiser: a cold autotune of
the gate and the IVF knobs by CUDA events into a persisted profile, a warm
compile that replays it, the roofline peaks fitted from the probes) and
cuts D2's store into 1, 2, 4 and 8 doc shards, merged bit-equal to the
unsharded search.  Last come the mixture-of-experts LMs: the flash kernel
at their prefill shapes (OLMoE's MHA; Llama-4's 40-over-8 heads at 16,384
tokens, chunked at 8,192 and global), one full-width MoE layer of each on
the card against the CPU (outputs and gradients), then cells G2 (G1's
pipeline on OLMoE-1B-7B at full width, 250 T topics, then an 8-slot decode
pool) and G3 (Llama-4-Scout at full width and 8 of 48 layers, 16 T topics
with 16,384-token prompts of 64 documents), each freed before the next LM
is drawn, with their routing, their tokens through the graphs held to the
eager run, and each layer's attention on the kernel held to the einsum
path.  Then the training path: ``flash_attention_xla`` (the kernel's
forward under an ``autograd.Function`` with a plain backward) against
autograd through the plain version at Qwen2's and Llama-4's heads, cell T1
(Qwen2-1.5B at full width trained through ``launch.train.train_lm``: bf16,
remat, 4 x 4,096 tokens a step in 2 micro-batches, steps timed by CUDA
events, one profiled), and a StepGuard replay after an injected failure,
bit-equal to the run without it.  Last, phase Z: the model zoo at its
published widths in fp32 (each zoo arch's reduced config on the card held
to the CPU; cell Z1, DCN-v2, AutoInt, DIEN and MIND trained, served and
scoring a million candidates at the four recsys cells, serve_p99's outputs
held to the CPU's; cell Z2, gat-cora trained at its four graph cells, the
Reddit-sized one sampled on the host), each cell's step and arguments
from ``launch.steps.build_bundle`` and its peak memory beside its dry
run's.  Then phase X, the launch layer: the flash kernels at d_head 32
against their plain version, the four examples of
``repro_torch.examples`` at their own sizes (each kernel's launches held
to the route their compiles give, the results to a CPU run),
``train_lm``'s 10m preset on the flash kernel, the serve demo against the
CPU, and qwen2-1.5b's full-width serve bundles, long_500k and decode_32k
at 14 of its 28 layers, each one decode step, their peak memory held to
their dry runs.  Last, phase M: the LM serve steps on a mesh of the cards
present, one NCCL process a card (check 1: qwen2-1.5b, internlm2-1.8b on
the flash kernel and olmoe-1b-7b with its routes pinned, at full width and
2 layers in bf16, sharded against rank 0's card alone; with 4 cards, cells
M1-M3 at full depth on a 2x2 mesh, each rank's peak memory held to its dry
run, M2's flash kernel held to its plain version at each rank's shape, the
flash launches of every rank counted; check 3: one AdamW step of the same
LMs in fp32 on the flash training path, sharded against rank 0's card
alone; with 4 cards, cell M4: qwen2-1.5b's train_4k at full width and
depth on the 2x2 mesh, 256 x 4,096 tokens a step, each rank's peak held to
its dry run).  ``python3 chip_smoke.py --phase M`` runs the toolchain and
phase M alone (with 4 cards: M1-M4).  Last, phase Q: the query engine
over the cards present, driven by this one process, on an index and dense
state of its own (Q0: the retrieval kernels at a card's shard shapes on
the last card while the first is current; Q1: the reference's
engine-scaling workloads on 1, 2 and 4 cards against the sequential loop;
Q2: RQ1, RQ2 and D1-D4 on every card, bit-equal to one card, each kernel
counted on each card; Q3: D2's doc shards on a ("data", "docs") mesh; Q4:
S1's ql and top10 served across the cards; Q5: the fat step per card of
the production meshes, priced on the host).  ``python3 chip_smoke.py
--phase Q`` runs the toolchain and phase Q alone (with 4 cards: every row).
Every phase that fails stops the run with a non-zero exit.  The last two
lines are a JSON object per kernel and the result line::

    {"kernels": [...]}
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Without a CUDA device, or without the rest of the repository beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

CHUNK = 16
#: the engine's ladder on the backends of the cells RQ1-P1: one rung, the
#: chunk their readings in PERF.md were taken at (the served cell S1 takes
#: the default ladder)
LADDER = (CHUNK,)
#: where the main path runs (the card; a rehearsal on the CPU may change it)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM data sheet, fp32 outside tensor cores
BF16_TC_OPS_PER_S = 989e12       # H100 SXM data sheet, dense bf16 tensor cores
RQ2_MODELS = ("BM25", "QL", "TF_IDF")
#: k of the top-k sweeps: both sides of each size of the warp select's
#: queue (32, 64 or 128 keys a warp) and its largest k
TOPK_KS = (1, 8, 10, 31, 32, 33, 64, 65, 80, 128)
#: k of the PQ-scoring sweep (D4's shortlist is 80)
PQ_KS = (1, 10, 32, 33, 80, 128)
#: cell G1, the RAG answer stage: prompt and decode lengths, documents per
#: prompt, the reranked depth the prompt reads
G1_PROMPT, G1_NEW, G1_DOCS, G1_DEPTH = 1024, 32, 4, 8
#: cell S1, the served path: requests of each SLO burst and their deadline
#: (benchmarks/serve_bench.py's), RAG requests, decode slots
S1_SLO, S1_SLO_MS, S1_RAG, S1_SLOTS = 64, 250.0, 32, 8
#: least share of the 250 T topics whose first generated token the kernel
#: path and the einsum path agree on (both bf16, same weights).  Both
#: round the probabilities to bf16 before the PV product (the einsum path
#: casts them to v's type, the bf16 kernel feeds them to wgmma as bf16),
#: but they sum in other orders, and a 151,936-way argmax over bf16 logits
#: flips where the top two lie within a rounding: 244-245 of 250 agreed on
#: the H100 with the earlier fp32-probability kernel (PERF.md, G1); 0.95
#: leaves room for another card's sums
G1_FIRST_TOKEN_MIN = 0.95



class RagCell(NamedTuple):
    """A RAG answer-stage cell on a mixture-of-experts LM: G1's pipeline
    shape, ``Retrieve("BM25") >> DenseRerank() % depth >> Generate(...)``,
    bf16 on the flash kernel, random weights from seed 0."""
    name: str
    config: str            # module of repro_torch.configs
    layers: int | None     # the depth kept (None: the published depth)
    topics: int | None     # the first T topics (None: all 250)
    chunk: int             # queries a chunk: the engine's one rung
    prompt: int
    new: int
    docs: int
    depth: int
    pool_slots: int        # a decode pool on the same LM after (0: none)
    einsum_topics: int | None  # topics the einsum path decodes end to end


#: cell G2: OLMoE-1B-7B at full width and depth, G1's traffic and lengths;
#: then an 8-slot decode pool over 16 of its prompts; the einsum path end
#: to end on all 250 topics
G2 = RagCell("G2", "olmoe_1b_7b", None, None, 16, 1024, 32, 4, 8, 8, None)
#: cell G3: Llama-4-Scout at full width, 8 of its 48 layers (3 of 4
#: chunked at 8,192), 16,384-token prompts of 64 documents, 16 T topics;
#: the einsum path end to end on the first chunk (~10 s a chunk)
G3 = RagCell("G3", "llama4_scout_17b_a16e", 8, 16, 4, 16384, 32, 64, 64, 0,
             4)

#: clock cycles that time_ms's spin holds the card, ~5 ms on an H100:
#: longer than the host's stalls seen while enqueueing a timed call (2.8 ms
#: on the H100, PERF.md), so that they do not reach the timed interval
SPIN_CYCLES = 10_000_000

#: every TPU kernel of the JAX package: function -> (status, file:line)
TPU_KERNELS = [
    ("streaming_topk_pallas", "ported",
     "src/repro/kernels/topk/topk.py:74"),
    ("fused_scoring_pallas", "ported",
     "src/repro/kernels/fused_scoring/fused_scoring.py:70"),
    ("dense_topk_pallas", "ported",
     "src/repro/kernels/dense_scoring/dense_scoring.py:55"),
    ("pq_topk_pallas", "ported",
     "src/repro/kernels/pq_scoring/pq_scoring.py:69"),
    ("flash_attention_pallas", "ported",
     "src/repro/kernels/flash_attention/flash_attention.py:85"),
]


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds of one ``fn()`` over ``iters`` calls, each
    timed alone by CUDA events with a cold L2: before each call a 64 MiB
    write evicts the 50 MB L2, so the inputs come from HBM as the bound
    assumes, and a spin on the card ahead of it (SPIN_CYCLES) keeps the
    host's enqueue time out of the interval.  Two untimed rounds of the
    same steps come first, so that no first use (a kernel loaded lazily, an
    event created) holds the host up inside a timed one.  A call that the
    host finished enqueueing only after the card had finished the spin and
    the write may hold host time; such calls are logged, and counted in the
    mean all the same."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times, late = [], []
    for i in range(2 + iters):
        before, start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(3))
        t0 = time.perf_counter()
        before.record()
        torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        start.record()
        fn()
        end.record()
        host = 1e3 * (time.perf_counter() - t0)
        end.synchronize()
        if i >= 2:
            ms, spin = start.elapsed_time(end), before.elapsed_time(start)
            times.append(ms)
            if host > spin:
                late.append((round(ms, 4), round(host, 4), round(spin, 4)))
    if late:
        log(f"[timing] {len(late)} of {iters} calls were enqueued after the "
            f"card's spin and write ended, so they may hold host time "
            f"(device ms, host ms, spin + write ms): {late}")
    return sum(times) / iters


def time_in_turns(kernel, plain, library):
    """``time_ms`` of a kernel, its plain version and its library call, in
    turns (kernel, plain, library, kernel): the kernel's two readings and
    the others'.  A kernel's row reports the mean of its two readings and
    logs both, as the flash row does."""
    ms_a = time_ms(kernel)
    plain_ms = time_ms(plain)
    lib_ms = time_ms(library)
    return (ms_a, time_ms(kernel)), plain_ms, lib_ms


def topk_overlap(a, b, k: int) -> float:
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return sum(len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist())) / k
               for x, y in zip(a, b)) / len(a)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least milliseconds the card could take: the larger of the bytes
    over the HBM rate and the fp32 operations over the fp32 rate."""
    b, o = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS_PER_S
    return max(b, o), "bytes" if b >= o else "operations"


def ptxas_report(log: str) -> dict:
    """Each kernel entry of an ``nvcc -Xptxas -v`` log -> its registers,
    stack frame and spill bytes, keyed by its name (``name<args>``, or the
    mangled name where ``c++filt`` is not at hand)."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[name].update(stack=nums[0], spill_stores=nums[1],
                             spill_loads=nums[2])
        elif name and "Used" in line:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out), text=True,
                               capture_output=True, check=True).stdout.split(
                                   "\n")
    except (OSError, subprocess.CalledProcessError):
        return out
    # "void (anonymous namespace)::name<args>(params)" -> "name<args>"
    return {n.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void "): r for n, r in zip(names, out.values())}


def same_bits(a, b) -> bool:
    """Equal tensors, bit for bit: -0.0 and +0.0 differ."""
    import torch
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


#: the sources of the fusion gate's decisions on the main paths' compiles
GATE_SOURCES: dict = {}


def compile_checked(pipe, be, report: dict | None = None, **kw):
    """``compile_pipeline`` with its gate decisions held: each decided on
    the cost estimates, or rejected at a kernel's k limit; none
    ``"estimate_failed"``.  Their sources are tallied in GATE_SOURCES."""
    import repro_torch as rt
    rep = {} if report is None else report
    op = rt.compile_pipeline(pipe, be, report=rep, **kw)
    for d in rep.get("fusion_decisions", ()):
        assert d["source"] in ("estimate", "kernel_limit"), (pipe, d)
        GATE_SOURCES[d["source"]] = GATE_SOURCES.get(d["source"], 0) + 1
    return op


def zero_launches(device=None) -> None:
    """Set every kernel's launch counts to 0: the count its wrapper keeps
    on the host and the counts the kernel keeps on every card (on
    ``device`` alone when it is given: a rank of phase M its own)."""
    import torch
    from repro_torch import kernels
    for i in range(torch.cuda.device_count()):
        if device is None or torch.device(device) == torch.device("cuda", i):
            torch.cuda.synchronize(i)
    for w in kernels.wrappers().values():
        w.launches = 0
    kernels.device_launches(device, reset=True)


def read_launches(*names, device=None) -> dict:
    """name -> {"device": runs of the kernel counted by the kernel itself,
    launched or replayed in a captured graph, summed over the cards (or
    on ``device`` alone); "host": launches counted by its wrapper on the
    host, eager or recorded into a graph being captured} since
    :func:`zero_launches`."""
    import torch
    from repro_torch import kernels
    for i in range(torch.cuda.device_count()):
        if device is None or torch.device(device) == torch.device("cuda", i):
            torch.cuda.synchronize(i)
    dev, ws = kernels.device_launches(device), kernels.wrappers()
    return {n: {"device": dev[n], "host": ws[n].launches} for n in names}


def assert_eager_launches(counts: dict, where: str) -> None:
    """On a path that captures no graph the two counts agree, and each
    kernel ran at least once."""
    for name, c in counts.items():
        assert c["device"] == c["host"], (where, name, c)
        assert c["device"] > 0, f"kernel {name} was not launched on {where}"


def signed_zeros(shape, p_pos, g):
    """-0.0 everywhere but a share p_pos of +0.0."""
    import torch
    return torch.where(torch.rand(shape, device=DEVICE, generator=g) < p_pos,
                       0.0, -0.0)


def _check_docids(ref_d, ref_s, d, rtol=2e-5, atol=1e-5) -> int:
    """Docids equal except at ranks where the reference's neighbouring
    scores tie within the tolerance (or at the last rank, whose neighbour
    lies past the cut); returns the number of such ranks."""
    n = 0
    for q, r in (ref_d != d).nonzero().tolist():
        row = ref_s[q]
        tol = atol + rtol * abs(float(row[r]))
        tied = r == row.shape[0] - 1 or any(
            0 <= j < row.shape[0] and abs(float(row[j] - row[r])) <= tol
            for j in (r - 1, r + 1))
        assert tied, (q, r, int(ref_d[q, r]), int(d[q, r]))
        n += 1
    return n


def phase_toolchain():
    import torch
    from repro_torch.common import card
    from repro_torch.kernels import _build
    nvcc = _build.find_nvcc()
    nv = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                        check=True).stdout.strip().splitlines()[-1]
    smi = card()
    log(f"[toolchain] python {sys.version.split()[0]}  torch "
        f"{torch.__version__}  cuda {torch.version.cuda}  nvcc: {nv}")
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log(f"[toolchain] kernels built in {build_s:.2f} s")
    reports = ptxas_report(_build.build_log())
    for name, rep in reports.items():
        log(f"[toolchain] ptxas: {name}: {rep}")
    # every instantiation of the kernels that take the warp select (3 queue
    # sizes: topk's segments and merge, dense_topk's 2 x 3 row kinds, and
    # pq_topk's 2 code loads) spill-free
    select = {n: r for n, r in reports.items()
              if any(f in n for f in ("topk_segments_kernel",
                                      "topk_merge_kernel",
                                      "dense_segments_kernel",
                                      "pq_cluster_kernel"))}
    assert len(select) == 3 * (1 + 1 + 6 + 2), list(select)
    for name, rep in select.items():
        assert rep["spill_stores"] == 0 and rep["spill_loads"] == 0, \
            (name, rep)
    log(f"[toolchain] 0 spill bytes in {sorted(select)}")
    return smi


def phase_floor() -> dict:
    """The floor under every kernel's time: an empty launch timed by
    ``time_ms`` as the kernels are, one block, and the grid of pq_topk at
    D4 (8 x 16 CTAs of 256 threads in clusters of 8)."""
    import torch
    from repro_torch.kernels import _build
    lib = _build.library()

    def empty(bx, by, threads, cluster):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.repro_empty_launch(bx, by, threads, cluster, stream),
                     "repro_empty_launch")

    floor = {"one block": (time_ms(lambda: empty(1, 1, 32, 1)),
                           time_ms(lambda: empty(1, 1, 32, 1))),
             "pq grid": (time_ms(lambda: empty(8, CHUNK, 256, 8)),
                         time_ms(lambda: empty(8, CHUNK, 256, 8)))}
    log(f"[floor] empty launch, ms (two readings): one block "
        f"{floor['one block']}, pq_topk's D4 grid of clusters "
        f"{floor['pq grid']}")
    return {name: sum(ms) / 2 for name, ms in floor.items()}


def phase_small_parity():
    """The slice end to end on a small corpus: the card (kernels) against
    the CPU (plain versions) through the same entry points."""
    import torch
    import repro_torch as rt
    from repro_torch.core import BackendDescriptor
    from repro_torch.index.corpus import synthesize_corpus, synthesize_topics
    corpus = synthesize_corpus(n_docs=3000, vocab=12000, mean_len=100, seed=7)
    topics = synthesize_topics(corpus, n_topics=8, q_len=3, rels_per_topic=12,
                               seed=8)
    caps = BackendDescriptor.default({"fat", "fused_topk", "fused_scoring"})
    pipes = [rt.Retrieve("BM25") % 10,
             (rt.Retrieve("BM25") >> (rt.Extract("QL") **
                                      rt.Extract("TF_IDF"))) % 20]
    out = {}
    for dev in ("cpu", "cuda"):
        be = rt.TorchBackend(rt.build_index(corpus, device=dev), default_k=60,
                             query_chunk=4, descriptor=caps, device=dev)
        Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                            device=dev)
        out[dev] = [rt.run_pipeline(p, Q, backend=be) for p in pipes]
    n_ties = 0
    for a, b in zip(out["cpu"], out["cuda"]):
        b = {key: v.cpu() for key, v in b.items()}
        torch.testing.assert_close(b["scores"], a["scores"], rtol=2e-5,
                                   atol=1e-5)
        n_ties += _check_docids(a["docids"], a["scores"], b["docids"])
        if "features" in a:
            same = a["docids"] == b["docids"]
            torch.testing.assert_close(b["features"][same],
                                       a["features"][same], rtol=2e-5,
                                       atol=1e-5)
    log("[small] card (kernels) and CPU (plain) agree on the 3000-doc corpus:"
        " scores/features within rtol 2e-5 / atol 1e-5, docids equal except "
        f"{n_ties} rank(s) inside a score tie")

    # the dense stage: embeddings built on each device agree; from the same
    # embeddings (so the host k-means builds the same lists and codes) the
    # four dense pipelines agree
    from repro_torch.index.dense import build_dense_index
    dense = {dev: build_dense_index(rt.build_index(corpus, device=dev))
             for dev in ("cpu", "cuda")}
    # the build sums each document's entries in their order on the card
    # too: a second build there is bit-equal to the first
    again = build_dense_index(rt.build_index(corpus, device="cuda"))
    assert same_bits(again.emb, dense["cuda"].emb), \
        "two dense builds on the card differ"
    torch.testing.assert_close(dense["cuda"].emb.cpu(), dense["cpu"].emb,
                               rtol=1e-5, atol=1e-6)
    card_cpu_equal = same_bits(dense["cuda"].emb.cpu(), dense["cpu"].emb)
    dpipes = [(rt.Retrieve("BM25", k=200) >> rt.DenseRerank(alpha=0.3)) % 10,
              rt.DenseRetrieve(k=10, nprobe=0) % 10,
              rt.DenseRetrieve(k=10, nprobe=8) % 10,
              rt.DenseRetrieve(k=10, nprobe=8, pq=True) % 10]
    out = {}
    for dev in ("cpu", "cuda"):
        be = rt.TorchBackend(rt.build_index(corpus, device=dev),
                             dense["cpu"], default_k=60, query_chunk=4,
                             ivf_lists=16, pq_m=8, device=dev)
        Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                            device=dev)
        out[dev] = [rt.run_pipeline(p, Q, backend=be) for p in dpipes]
        kinds = [compile_checked(p, be).kind for p in dpipes]
        assert kinds == ["fused_dense_rerank"] + ["fused_dense_retrieve"] * 3
    n_ties = 0
    for a, b in zip(out["cpu"], out["cuda"]):
        b = {key: v.cpu() for key, v in b.items()}
        torch.testing.assert_close(b["scores"], a["scores"], rtol=2e-5,
                                   atol=1e-5)
        n_ties += _check_docids(a["docids"], a["scores"], b["docids"])
    log("[small] dense: two builds on the card bit-equal; the card's "
        "embeddings within rtol 1e-5 / atol 1e-6 of the CPU's (bit-equal: "
        f"{card_cpu_equal}); D1-D4 (fused) agree card vs CPU, docids equal "
        f"except {n_ties} rank(s) inside a score tie")
    _small_rag(corpus, topics, dense["cpu"])


def _small_rag(corpus, topics, dense) -> None:
    """The RAG stage on the 3000-doc corpus: an fp32 LM of d_head 64 on the
    flash kernel (card) against the plain version (CPU), same weights."""
    import copy
    import torch
    import repro_torch as rt
    from repro_torch.core import Context
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import transformer_lm as tlm
    cfg = tlm.LMConfig(name="rag-small", n_layers=2, d_model=256, n_q=4,
                       n_kv=2, d_head=64, d_ff=512, vocab=4096,
                       qkv_bias=True, tie_embeddings=True,
                       dtype=torch.float32, attn_impl="pallas")
    lm = tlm.init_params(cfg, torch.Generator().manual_seed(0))
    lms = {"cpu": lm, "cuda": copy.deepcopy(lm).to("cuda")}
    P, T = 96, 8                          # a prompt of one and a half tiles
    gen = rt.Generate("rag-small", max_new_tokens=T, max_prompt_len=P,
                      prompt_docs=3)
    rag = rt.Retrieve("BM25") >> rt.DenseRerank() % 8 >> gen
    out = {}
    before = flash_attention.launches
    for dev in ("cpu", "cuda"):
        be = rt.TorchBackend(rt.build_index(corpus, device=dev), dense,
                             default_k=60, query_chunk=4, device=dev)
        be.register_lm("rag-small", cfg, lms[dev])
        Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                            device=dev)
        out[dev] = {k: v.cpu() for k, v in
                    rt.run_pipeline(rag, Q, backend=be).items()}
        if dev == "cpu":
            prompts = gen.assemble(Context(be), Q, out["cpu"])
    n_flash = flash_attention.launches - before
    assert n_flash == cfg.n_layers * 2, n_flash      # 2 chunks of 4 queries
    a, b = out["cpu"], out["cuda"]
    assert torch.equal(a["docids"], b["docids"])
    # a token may differ only where the CPU's logits at that step put the
    # card's token within a tie of the argmax; later tokens follow it
    ties = []
    for q in range(a["tokens"].shape[0]):
        diff = (a["tokens"][q] != b["tokens"][q]).nonzero()
        if len(diff) == 0:
            continue
        t = int(diff[0])
        seq = torch.cat([prompts[q], a["tokens"][q, :t]])[None]
        cache = tlm.init_kv_cache(cfg, 1, seq.shape[1], device="cpu")
        logits, _ = tlm.prefill(cfg, lm, seq, cache)
        gap = float(logits[0, a["tokens"][q, t]] - logits[0, b["tokens"][q, t]])
        tol = 1e-4 * float(logits.abs().max())
        assert 0 <= gap <= tol, (q, t, gap, tol)
        ties.append((q, t, gap))
    log(f"[small] RAG (fp32 LM, d_head 64, {P}-token prompts, {T} tokens, "
        f"flash kernel {n_flash} launches on the card): docids equal, tokens "
        f"equal card vs CPU except {len(ties)} row(s) from a near-tie of "
        f"logits within 1e-4 of their largest magnitude {ties}")


def phase_index():
    from repro_torch.index.robust04 import robust04
    index, forms, info = robust04(device=DEVICE)
    lens = index.term_start[1:] - index.term_start[:-1]
    log(f"[index] {index.n_docs} docs, {info['tokens']} tokens, "
        f"{int(index.doc_ids.numel())} padded postings; corpus+topics "
        f"{info['synth_s']:.1f} s, build_index {info['build_s']:.1f} s; "
        f"device bytes {index.nbytes()}; max_postings {int(lens.max())}; "
        f"max_fwd_len {index.max_fwd_len}")
    return index, forms


def phase_kernels(index, forms) -> dict:
    """Each kernel against its plain version on the card, at the shapes of
    one query chunk of the main path (the first 16 TDN topics)."""
    import torch
    from repro_torch.core.data import make_queries
    from repro_torch.index.inverted import gather_postings
    from repro_torch.index.retrieve import score_exhaustive
    from repro_torch.kernels.fused_scoring.ops import MODEL_OPS, fused_scoring
    from repro_torch.kernels.fused_scoring.ref import fused_scoring_ref
    from repro_torch.kernels.topk.ops import streaming_topk
    from repro_torch.kernels.topk.ref import streaming_topk_ref
    t = forms["TDN"]
    Q = make_queries(t.terms[:CHUNK], t.weights[:CHUNK], t.qids[:CHUNK],
                     device=DEVICE)
    mp = int((index.term_start[1:] - index.term_start[:-1]).max())
    rows = {}

    # -- top-k: real BM25 score rows, random rows, integer-tied rows
    real = score_exhaustive(index, Q["terms"], Q["weights"], model="BM25",
                            max_postings=mp)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    n = index.n_docs
    cases = {"bm25": real,
             "random": torch.randn(CHUNK, n, device=DEVICE, generator=g),
             "tied": torch.randint(0, 50, (CHUNK, n), device=DEVICE,
                                   generator=g).float(),
             # -0.0 ranks just below +0.0 (lax.top_k's order)
             "+-0": signed_zeros((CHUNK, n), 0.5, g),
             "-0, a few +0": signed_zeros((CHUNK, n), 1e-4, g)}
    err = 0.0
    for name, s in cases.items():
        for k in TOPK_KS:
            v1, i1 = streaming_topk(s, k=k)
            v2, i2 = streaming_topk_ref(s, k=k)
            torch.cuda.synchronize()
            assert same_bits(v1, v2), ("topk values", name, k)
            assert torch.equal(i1, i2), ("topk indices", name, k)
            err = max(err, float((v1 - v2).abs().max()))
    log("[kernels] topk equals its plain version (values bit for bit and "
        f"indices) on [{CHUNK}, {n}] {list(cases)} rows at k in {TOPK_KS} "
        f"(warp queues of 32, 64 and 128 keys)")
    # edges: one row, rows shorter than a segment, many rows, and rows of
    # ties, zeros or mostly -inf
    shapes = ((1, n), (3, 1000), (5, 5000), (2, 130), (250, 70001), (4, 20))
    for nq, m in shapes:
        u = torch.rand(nq, m, device=DEVICE, generator=g)
        # ascending rows: every element beats the warp select's k-th key
        up = torch.arange(m, device=DEVICE, dtype=torch.float32).expand(nq, m)
        for name, s in (("random", torch.randn(nq, m, device=DEVICE,
                                               generator=g)),
                        ("tied", (u * 50).floor()),
                        ("zeros", torch.zeros(nq, m, device=DEVICE)),
                        ("+-0", signed_zeros((nq, m), 0.5, g)),
                        ("neginf", torch.where(u < 0.999, -torch.inf, u)),
                        ("ascending", up.contiguous())):
            for k in TOPK_KS:
                if k > m:
                    continue
                v1, i1 = streaming_topk(s, k=k)
                v2, i2 = streaming_topk_ref(s, k=k)
                assert same_bits(v1, v2) and torch.equal(i1, i2), \
                    ("topk edge", nq, m, name, k)
    log("[kernels] topk equals its plain version on the edge sweep "
        f"{shapes} x random/tied/zeros/+-0/-inf/ascending rows x k in "
        f"{TOPK_KS}")
    k = 10
    (ms_a, ms_b), plain, lib = time_in_turns(
        lambda: streaming_topk(real, k=k),
        lambda: streaming_topk_ref(real, k=k), lambda: torch.topk(real, k))
    ms = (ms_a + ms_b) / 2
    nbytes = real.numel() * 4 + CHUNK * k * 8
    rows["topk"] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                    "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                    "bound_by": "bytes", "max_abs_err": err,
                    "shape": f"[{CHUNK}, {n}] k={k}"}
    log(f"[kernels] topk [{CHUNK}, {n}] k={k}: kernel {ms_a:.4f} / "
        f"{ms_b:.4f} ms (mean {ms:.4f}), plain {plain:.4f} ms, torch.topk "
        f"{lib:.4f} ms, bound {rows['topk']['bound_ms']:.4f} ms (bytes)")
    # rows that keep the warp select's bar low, so that many elements take
    # its slow path, timed at the same shape beside the random rows (not in
    # the kernels line): all equal, small-integer ties, mostly -inf, and
    # ascending rows, where every element beats the bar
    u = torch.rand(CHUNK, n, device=DEVICE, generator=g)
    slow = {"random": cases["random"],
            "zeros": torch.zeros(CHUNK, n, device=DEVICE),
            "tied": cases["tied"],
            "neginf": torch.where(u < 0.999, -torch.inf, u),
            "ascending": torch.arange(n, device=DEVICE, dtype=torch.float32)
            .expand(CHUNK, n).contiguous()}
    slow_ms = {}
    for name, s in slow.items():
        a = time_ms(lambda s=s: streaming_topk(s, k=k))
        slow_ms[name] = (a, time_ms(lambda s=s: streaming_topk(s, k=k)))
    log(f"[kernels] topk [{CHUNK}, {n}] k={k} by row kind, kernel ms (two "
        f"readings): " + json.dumps(slow_ms))

    # -- fused scoring: the chunk's gathered postings, passed as
    # retrieve_fat_fused passes them (df and cf once per posting list)
    post = gather_postings(index, Q["terms"], mp)
    dl = index.doc_len[post["doc_ids"]]
    shape = post["tfs"].shape
    cols = [post["tfs"], dl, post["df"][..., None], post["cf"][..., None]]
    stats = index.stats
    kw = dict(n_docs=stats["n_docs"], avg_dl=stats["avg_doclen"],
              total_terms=stats["total_terms"])
    N, lists = cols[0].numel(), cols[2].numel()
    err = 0.0
    for models in (("BM25", "TF_IDF", "QL", "DPH", "Coord"), RQ2_MODELS):
        a = fused_scoring(*cols, models=models, stats=stats)
        b = fused_scoring_ref(*cols, models=models, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5)
        err = max(err, float((a - b).abs().max()))
        log(f"[kernels] fused_scoring {models} on {N} gathered postings "
            f"({'x'.join(map(str, shape))}) within rtol 2e-5 / atol 1e-5 of "
            f"its plain version, max abs err {err:.3e}")
    F = len(RQ2_MODELS)
    per_posting = fused_scoring(*(c.expand(shape).reshape(-1) for c in cols),
                                models=RQ2_MODELS, stats=stats)
    assert torch.equal(per_posting.reshape(*shape, F),
                       fused_scoring(*cols, models=RQ2_MODELS, stats=stats))
    del per_posting
    log("[kernels] fused_scoring with df/cf per posting list equals it with "
        "df/cf per posting")
    ms = time_ms(lambda: fused_scoring(*cols, models=RQ2_MODELS, stats=stats))
    plain = time_ms(lambda: fused_scoring_ref(*cols, models=RQ2_MODELS, **kw))
    nbytes = N * (8 + 4 * F) + lists * 8
    ops = N * sum(MODEL_OPS[m] for m in RQ2_MODELS)
    b_bytes, b_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS_PER_S
    rows["fused_scoring"] = {
        "ms": ms, "plain_ms": plain, "library_ms": None,
        "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "max_abs_err": err, "shape": f"[{N}] x {F} models"}
    log(f"[kernels] fused_scoring {N} postings x {F} models: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {max(b_bytes, b_ops):.4f}"
        f" ms ({rows['fused_scoring']['bound_by']}; bytes {b_bytes:.4f}, "
        f"operations {b_ops:.4f})")
    return rows


def phase_dense_build(index) -> dict:
    """The dense state of the Robust04-scale collection on the card, and
    the backends of the dense main path over it."""
    import repro_torch as rt
    from repro_torch.index.dense import build_dense_index, pq_store_bytes
    from repro_torch.index.robust04 import PQ_M, PQ_REFINE, robust04_dense
    dense, ivf, ivfpq, info = robust04_dense(index)
    n = index.n_docs
    # a second build of the embeddings: bit-equal to the first
    t0 = time.perf_counter()
    again = build_dense_index(index)
    again_s = time.perf_counter() - t0
    assert same_bits(again.emb, dense.emb), \
        "two Robust04-scale dense builds on the card differ"
    del again
    log(f"[dense] a second build of the embeddings {again_s:.2f} s: "
        f"bit-equal to the first")
    flat = dense.emb.numel() * dense.emb.element_size() / n
    pq = pq_store_bytes(ivfpq) / n
    log(f"[dense] built on {dense.emb.device}: embeddings [{n}, {dense.dim}] "
        f"{info['dense_s']:.2f} s (on the device), IVF {ivf.n_lists} lists "
        f"{info['ivf_s']:.2f} s (host k-means + list-ordered copy), PQ m="
        f"{PQ_M} {info['pq_s']:.2f} s (host codebooks + codes); max_list_len "
        f"{ivf.max_list_len}; bytes per document: flat {flat:.2f}, PQ "
        f"{pq:.2f}, reduction {flat / pq:.2f}x")
    kw = dict(default_k=1000, bucket_ladder=LADDER, device=DEVICE)
    return {"index": index, "dense": dense, "ivf": ivf, "ivfpq": ivfpq,
            "be": rt.TorchBackend(index, dense, ivf=ivf, **kw),
            "be_pq": rt.TorchBackend(index, dense, ivfpq=ivfpq, pq_m=PQ_M,
                                     pq_refine=PQ_REFINE, **kw)}


def phase_dense_kernels(index, forms, state) -> dict:
    """The dense- and PQ-scoring kernels against their plain versions on
    the card, at the shapes of the first chunk of 16 T topics on the dense
    main path: D2's shared store, D3's gathered IVF rows, D1's gathered
    rerank candidates, D4's gathered codes — with and without base, with
    duplicate rows and codes, NEG-masked rows, rows shorter than a
    segment, a dim that is not a multiple of 4 (the kernel's scalar loads)
    and k in (1, 10, 80, 128)."""
    import torch
    from repro_torch.core.data import make_queries
    from repro_torch.index import dense as DN
    from repro_torch.index.retrieve import retrieve_topk
    from repro_torch.index.robust04 import NPROBE, PQ_REFINE
    from repro_torch.kernels.dense_scoring.ops import streaming_dense_topk
    from repro_torch.kernels.dense_scoring.ref import dense_topk_ref
    from repro_torch.kernels.pq_scoring.ops import streaming_pq_topk
    from repro_torch.kernels.pq_scoring.ref import pq_topk_ref
    t = forms["T"]
    Q = make_queries(t.terms[:CHUNK], t.weights[:CHUNK], t.qids[:CHUNK],
                     device=DEVICE)
    be, pqi = state["be"], state["ivfpq"]
    qv = be.embed_queries(Q)
    emb = state["dense"].emb
    n, dim = emb.shape
    # D3: the IVF-flat candidate rows; D1: BM25's 200 candidates with
    # alpha * bm25 as base; D4: the IVF-PQ candidate codes and tables
    emb_c, base_c, _ = DN._ivf_candidates(state["ivf"], qv, nprobe=NPROBE)
    docs, bm25 = retrieve_topk(index, Q["terms"], Q["weights"], model="BM25",
                               k=200, max_postings=be.max_postings)
    emb_r = emb[docs.clamp(min=0).long()]
    base_r = torch.where(docs >= 0, 0.3 * bm25, DN.NEG)
    # G1: BM25's 1,000 candidates, DenseRerank() (alpha 0) to depth 8
    docs_g = retrieve_topk(index, Q["terms"], Q["weights"], model="BM25",
                           k=1000, max_postings=be.max_postings)[0]
    emb_g = emb[docs_g.clamp(min=0).long()]
    base_g = torch.where(docs_g >= 0, 0.0, DN.NEG)
    codes_c, table, base_p, _, r = DN._pq_candidates(
        pqi, qv, k=10, nprobe=NPROBE, refine=PQ_REFINE, shortlist=None)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    dup = emb.clone()
    dup[1::2] = dup[0:n - 1:2]                  # every odd row repeats
    short = emb[:1500]
    masked = torch.where(torch.rand(CHUNK, n, device=DEVICE, generator=g)
                         < 0.999, DN.NEG, 0.0)
    # dim 62: scalar loads, for shared rows in groups of 8 and of 3
    # queries and for gathered rows
    e62, q62 = emb[:, :62].contiguous(), qv[:, :62].contiguous()
    # small-integer embeddings and queries: integer scores, exact in any
    # order, with many ties at every rank
    e_int = torch.randint(-2, 3, emb.shape, device=DEVICE, generator=g).float()
    q_int = torch.randint(-2, 3, qv.shape, device=DEVICE, generator=g).float()
    cases = {"D2 shared": (emb, qv, None),
             "D2 shared +base": (emb, qv, masked),
             "D2 tied (integer scores)": (e_int, q_int, None),
             "D2 shared, 12 queries": (emb, qv[:12], None),
             "D2 duplicate rows": (dup, qv, None),
             "D3 gathered": (emb_c, qv, base_c),
             "D3 no base": (emb_c, qv, None),
             "D1 rerank": (emb_r, qv, base_r),
             "G1 rerank": (emb_g, qv, base_g),
             # G3: a chunk of 4 queries reranked to depth 64
             "G3 rerank, 4 queries": (emb_g[:G3.chunk], qv[:G3.chunk],
                                      base_g[:G3.chunk]),
             "shorter than a segment": (short, qv, None),
             "[16, 100, 64] rows": (emb_r[:, :100], qv, None),
             "dim 62 shared": (e62, q62, masked),
             "dim 62 shared, 3 queries": (e62, q62[:3], None),
             "dim 62 gathered": (emb_r[..., :62].contiguous(), q62, base_r),
             # every score a signed zero: 0 . q, then + base of -0.0 or +0.0
             "zero rows, +-0 base": (torch.zeros_like(emb_r), qv,
                                     signed_zeros(base_r.shape, 0.5, g))}
    err, n_ties = 0.0, 0
    for name, (e, q, b) in cases.items():
        for k in TOPK_KS:
            if k > e.shape[-2]:
                continue
            v1, i1 = streaming_dense_topk(e, q, b, k=k)
            v2, i2 = dense_topk_ref(e, q, b, k=k)
            torch.cuda.synchronize()
            if e is e_int or name == "zero rows, +-0 base":
                assert same_bits(v1, v2) and torch.equal(i1, i2), (name, k)
            torch.testing.assert_close(v1, v2, rtol=1e-5, atol=1e-5)
            n_ties += _check_docids(i2, v2, i1, rtol=1e-5, atol=1e-5)
            err = max(err, float((v1 - v2).abs().max()))
    log(f"[dense kernels] dense_topk within rtol/atol 1e-5 of its plain "
        f"version on {list(cases)} x k in {TOPK_KS}: max abs err "
        f"{err:.3e}, docids equal except {n_ties} rank(s) inside a tie "
        f"(integer and signed-zero scores: values and docids equal); D3 rows "
        f"{tuple(emb_c.shape)}, D1 rows {tuple(emb_r.shape)}, G1 rows "
        f"{tuple(emb_g.shape)}")
    rows = {}
    g3 = slice(0, G3.chunk)
    shapes = {"D2": (emb, qv, None, 10), "D3": (emb_c, qv, base_c, 10),
              "D1": (emb_r, qv, base_r, 10),
              "G1": (emb_g, qv, base_g, G1_DEPTH),
              "G3": (emb_g[g3], qv[g3], base_g[g3], G3.depth)}
    for name, (e, qx, b, k) in shapes.items():
        nq, c = qx.shape[0], e.shape[-2]
        nbytes = e.numel() * 4 + qx.numel() * 4 + nq * k * 8 + \
            (0 if b is None else b.numel() * 4)
        bms, by = bound(nbytes, 2 * nq * c * dim)
        if e.dim() == 2:
            def library():
                return torch.topk(qx @ e.T, k)
        else:
            def library():
                return torch.topk(torch.baddbmm(
                    b[..., None], e, qx[..., None])[..., 0], k)
        (ms_a, ms_b), plain, lib = time_in_turns(
            lambda: streaming_dense_topk(e, qx, b, k=k),
            lambda: dense_topk_ref(e, qx, b, k=k), library)
        ms = (ms_a + ms_b) / 2
        rows[f"dense_topk {name}"] = {
            "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
            "bound_by": by, "max_abs_err": err,
            "shape": f"{'x'.join(map(str, e.shape))} x {nq} queries k={k}"}
        log(f"[dense kernels] dense_topk {name} {tuple(e.shape)} x {nq} "
            f"queries k={k}: "
            f"kernel {ms_a:.4f} / {ms_b:.4f} ms (mean {ms:.4f}), plain "
            f"{plain:.4f} ms, "
            f"library (two calls: matmul + torch.topk) {lib:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")

    # pq_topk: for nq in (1, 16, 40) queries (D4's chunk, cut or repeated)
    # and m in (16, 8) subspaces (D4's codes and tables, or their first 8:
    # the kernel's byte loads), D4's codes, random codes, duplicated code
    # words, one value in the whole table, a table of -0.0 with a few +0.0,
    # bases mostly NEG, rows fewer than a CTA's 16 x 8, codes in {0, 1}:
    # values bit for bit and indices, one launch a call
    nq0, c, m0 = codes_c.shape
    n_calls = 0
    for nq in (1, CHUNK, 40):
        rep_q = torch.arange(nq, device=DEVICE) % nq0
        for m in (m0, 8):
            cc = codes_c[rep_q][..., :m].contiguous()
            tab = table[rep_q][:, :m].contiguous()
            bb = base_p[rep_q]
            rnd = torch.randint(0, 256, cc.shape, device=DEVICE, generator=g,
                                dtype=torch.uint8)
            dup = cc.clone()
            dup[:, 1::2] = dup[:, 0:c - 1:2]
            neg = torch.where(torch.rand(bb.shape, device=DEVICE, generator=g)
                              < 0.99, DN.NEG, bb)
            pcases = {"D4 codes": (cc, tab, bb),
                      "random codes, no base": (rnd, tab, None),
                      "duplicated code words": (dup, tab, bb),
                      "one value": (cc, torch.full_like(tab, 0.25), None),
                      "-0 and a few +0": (cc, signed_zeros(tab.shape, 0.002,
                                                           g), None),
                      "bases mostly NEG": (rnd, tab, neg),
                      "100 rows": (cc[:, :100], tab, bb[:, :100]),
                      "codes in {0, 1}": (rnd % 2, tab, None),
                      # the table laid out [m, nq, n_codes], as the ADC
                      # einsum leaves it, and rows off 16 bytes (the
                      # kernel's ordinary loads)
                      "[m, nq, n_codes] table": (
                          cc, tab.transpose(0, 1).contiguous().transpose(0, 1),
                          bb),
                      "table rows off 16 bytes": (
                          cc, torch.zeros(nq, m, tab.shape[2] + 1,
                                          device=DEVICE)[..., 1:].copy_(tab),
                          bb)}
            for name, (cx, tx, bx) in pcases.items():
                for k in PQ_KS:
                    if k > cx.shape[1]:
                        continue
                    before = streaming_pq_topk.launches
                    v1, i1 = streaming_pq_topk(cx, tx, bx, k=k)
                    assert streaming_pq_topk.launches == before + 1
                    v2, i2 = pq_topk_ref(cx, tx, bx, k=k)
                    torch.cuda.synchronize()
                    assert same_bits(v1, v2) and torch.equal(i1, i2), \
                        ("pq_topk", nq, m, name, k)
                    n_calls += 1
    log(f"[dense kernels] pq_topk equals its plain version (values bit for "
        f"bit and indices) in {n_calls} calls, one launch each: nq in (1, "
        f"{CHUNK}, 40) x m in ({m0}, 8) x {list(pcases)} x k in {PQ_KS}; "
        f"D4 codes {tuple(codes_c.shape)}, shortlist r={r}")
    nbytes = c * nq0 * (m0 + 4) + table.numel() * 4 + nq0 * r * 8
    bms, by = bound(nbytes, nq0 * c * m0)
    ms_a = time_ms(lambda: streaming_pq_topk(codes_c, table, base_p, k=r))
    plain = time_ms(lambda: pq_topk_ref(codes_c, table, base_p, k=r))
    ms_b = time_ms(lambda: streaming_pq_topk(codes_c, table, base_p, k=r))
    ms = (ms_a + ms_b) / 2
    rows["pq_topk D4"] = {"ms": ms, "plain_ms": plain, "library_ms": None,
                          "bound_ms": bms, "bound_by": by, "max_abs_err": 0.0,
                          "shape": f"{nq0}x{c}x{m0} uint8 k={r}"}
    log(f"[dense kernels] pq_topk D4 ({nq0}, {c}, {m0}) k={r}, table "
        f"strides {table.stride()}: kernel {ms_a:.4f} / {ms_b:.4f} ms (mean "
        f"{ms:.4f}), plain {plain:.4f} ms, library none (no single call), "
        f"bound {bms:.4f} ms ({by})")
    return rows


def on_host(obj):
    """A copy of an index dataclass with every tensor on the host (nested
    dataclasses too)."""
    import dataclasses
    import torch

    def move(v):
        if isinstance(v, torch.Tensor):
            return v.cpu()
        return on_host(v) if dataclasses.is_dataclass(v) else v
    return dataclasses.replace(obj, **{f.name: move(getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)})


def phase_dense(forms, state) -> None:
    """D1-D4 on the 250 T topics, each unoptimised and optimised through
    ``Experiment(measure_time=True)``; then D4 once more on the host (the
    plain versions) from the same state, whose ranking the card's must
    equal."""
    import torch
    import repro_torch as rt
    from repro_torch.index.robust04 import NPROBE
    topics = forms["T"]
    Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                        device=DEVICE)
    pipes = {
        "D1": ((rt.Retrieve("BM25", k=200) >> rt.DenseRerank(alpha=0.3)) % 10,
               state["be"], "fused_dense_rerank"),
        "D2": (rt.DenseRetrieve(k=10, nprobe=0) % 10, state["be"],
               "fused_dense_retrieve"),
        "D3": (rt.DenseRetrieve(k=10, nprobe=NPROBE) % 10, state["be"],
               "fused_dense_retrieve"),
        "D4": (rt.DenseRetrieve(k=10, nprobe=NPROBE, pq=True) % 10,
               state["be_pq"], "fused_dense_retrieve")}
    from repro_torch.kernels.dense_scoring.ops import streaming_dense_topk
    res, per_cell = {}, {}
    for name, (pipe, be, kind) in pipes.items():
        got = compile_checked(pipe, be).kind
        assert got == kind, (name, got)
        out = {}
        before = streaming_dense_topk.launches
        for setting, opt in (("unoptimised", False), ("optimised", True)):
            r = rt.Experiment([pipe], Q, topics.qrels, ["map", "ndcg_cut_10"],
                              backend=be, optimize=opt, measure_time=True)
            out[setting] = (r["table"][0], r["results"][0])
        per_cell[name] = streaming_dense_topk.launches - before
        (ru, Ru), (ro, Ro) = out["unoptimised"], out["optimised"]
        assert Ro["docids"].shape == (len(topics.qids), 10)
        assert bool(Ro["scores"].isfinite().all())
        ovl = topk_overlap(Ru["docids"], Ro["docids"], 10)
        assert ovl >= 0.99, (name, ovl)
        res[name] = Ro
        log(f"[dense] {name} T unoptimised mrt_ms {ru['mrt_ms']:.4f} map "
            f"{ru['map']:.4f}  optimised ({got}) mrt_ms {ro['mrt_ms']:.4f} "
            f"map {ro['map']:.4f} ndcg_cut_10 {ro['ndcg_cut_10']:.4f}  "
            f"overlap@10 fused vs unfused {ovl:.4f}")
    for name in ("D3", "D4"):
        log(f"[dense] recall@10 of {name} against D2 (brute force): "
            f"{topk_overlap(res[name]['docids'], res['D2']['docids'], 10):.4f}")
    log(f"[dense] dense_topk launches by cell: {per_cell}")
    from repro_torch.index.robust04 import PQ_M, PQ_REFINE
    host = rt.TorchBackend(on_host(state["index"]), on_host(state["dense"]),
                           ivfpq=on_host(state["ivfpq"]), pq_m=PQ_M,
                           pq_refine=PQ_REFINE, default_k=1000,
                           bucket_ladder=LADDER, device="cpu")
    Qh = rt.make_queries(topics.terms, topics.weights, topics.qids,
                         device="cpu")
    Rh = rt.run_pipeline(pipes["D4"][0], Qh, backend=host)
    card = {key: v.cpu() for key, v in res["D4"].items()}
    torch.testing.assert_close(card["scores"], Rh["scores"], rtol=2e-5,
                               atol=1e-5)
    n_ties = _check_docids(Rh["docids"], Rh["scores"], card["docids"])
    d2 = res["D2"]["docids"].cpu()
    log(f"[dense] D4 on the host (plain versions) from the same state: "
        f"scores within rtol 2e-5 / atol 1e-5 of the card's, docids equal "
        f"except {n_ties} rank(s) inside a score tie; recall@10 against D2 "
        f"card {topk_overlap(card['docids'], d2, 10):.4f}, host "
        f"{topk_overlap(Rh['docids'], d2, 10):.4f}")


def phase_attention_kernels() -> dict:
    """The flash-attention kernels against their plain version on the card:
    the JAX package's sweep (MHA/GQA/MQA x f32/bf16, chunk 32 and 128), one
    query row, ragged S and T, T < S with rows whose chunk holds no key,
    and G1's prefill shape, at the JAX contract's atol (2e-6 f32 on the
    CUDA-core kernel, 2e-2 bf16 on the wgmma kernel); bf16 also at S and T
    ragged against the wgmma kernel's 128-row tiles; then the wgmma
    kernel's ptxas report and G1's timings."""
    import re
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.configs import qwen2_1_5b
    cfg = qwen2_1_5b.model_cfg()
    g = torch.Generator(device=DEVICE).manual_seed(0)
    tol = {torch.float32: 2e-6, torch.bfloat16: 2e-2}
    # (B, S, T, H, Hkv, D, causal, chunk)
    cases = [(1, 128, 128, 2, 2, 64, True, 0), (2, 256, 256, 4, 2, 64, True, 0),
             (1, 256, 256, 8, 1, 128, True, 0),
             (1, 256, 256, 4, 2, 64, True, 32),
             (1, 256, 256, 4, 2, 64, True, 128),
             (2, 1, 1, 12, 2, 128, True, 0), (2, 1, 70, 4, 2, 64, False, 0),
             (3, 100, 100, 12, 2, 128, True, 0),
             (2, 70, 131, 4, 2, 64, False, 0),
             (2, 200, 200, 4, 2, 64, True, 48),
             # rows whose chunk starts at or past T see no key
             (2, 100, 70, 4, 2, 64, True, 32),
             (2, 130, 70, 4, 2, 128, False, 48),
             (CHUNK, G1_PROMPT, G1_PROMPT, cfg.n_q, cfg.n_kv, cfg.d_head,
              True, 0),
             # G3's grouping (40 q heads over 8 kv heads) with a chunk;
             # G2's MHA (16 over 16) at its prompt length
             (1, 256, 256, 40, 8, 128, True, 64),
             (2, 1024, 1024, 16, 16, 128, True, 0)]
    # ragged against the bf16 kernel's 128-row q and kv tiles; the last,
    # 576 work tiles of one or two kv tiles, crosses the persistent CTAs'
    # work-tile boundaries many times
    bf16_cases = [(1, 129, 129, 12, 2, 128, True, 0),
                  (1, 1000, 1000, 12, 2, 128, True, 0),
                  (1, 1023, 1023, 12, 2, 128, True, 0),
                  (1, 1000, 1000, 4, 2, 64, True, 0),
                  (24, 129, 129, 12, 2, 128, True, 0)]
    # f32: the kernel within the contract's 2e-6 of the plain version
    # evaluated in float64 (the exact function of these inputs), and within
    # 4e-6 of the plain version in float32, which sums in its own order and
    # is itself up to 2e-6 from the exact function; bf16: both round one
    # fp32 result (the kernel's P V from P in bf16), within 2e-2 of each
    # other
    err = {"f32 vs f64": 0.0, "f32 vs plain": 0.0, "plain f32 vs f64": 0.0,
           "bf16 vs plain": 0.0}
    runs = [(c, dt) for c in cases for dt in (torch.float32, torch.bfloat16)]
    runs += [(c, torch.bfloat16) for c in bf16_cases]
    for (B, S, T, H, HKV, D, causal, chunk), dt in runs:
        q = torch.randn(B, S, H, D, device=DEVICE, generator=g).to(dt)
        k = torch.randn(B, T, HKV, D, device=DEVICE, generator=g).to(dt)
        v = torch.randn(B, T, HKV, D, device=DEVICE, generator=g).to(dt)
        a = flash_attention(q, k, v, causal=causal, chunk=chunk)
        b = flash_attention_ref(q, k, v, causal=causal, chunk=chunk)
        torch.cuda.synchronize()
        assert a.dtype == dt and a.shape == q.shape
        diff = float((a.float() - b.float()).abs().max())
        if dt == torch.bfloat16:
            assert diff <= tol[dt], (B, S, T, H, HKV, D, chunk, diff)
            err["bf16 vs plain"] = max(err["bf16 vs plain"], diff)
            continue
        exact = flash_attention_ref(q.double(), k.double(), v.double(),
                                    causal=causal, chunk=chunk)
        e_k = float((a.double() - exact).abs().max())
        e_p = float((b.double() - exact).abs().max())
        assert e_k <= tol[dt] and diff <= 2 * tol[dt], \
            (B, S, T, H, HKV, D, chunk, e_k, diff, e_p)
        for key, e in (("f32 vs f64", e_k), ("f32 vs plain", diff),
                       ("plain f32 vs f64", e_p)):
            err[key] = max(err[key], e)
        del exact
    log(f"[attention kernels] flash_attention on (B, S, T, H, Hkv, D, causal,"
        f" chunk) = {cases} x f32/bf16 and {bf16_cases} x bf16: f32 (CUDA-"
        f"core kernel) within atol 2e-6 of the plain version in float64 and "
        f"4e-6 of it in float32, bf16 (wgmma kernel) within 2e-2 of the "
        f"plain version; max abs err "
        f"{ {k: float(f'{e:.3e}') for k, e in err.items()} }")

    # the wgmma kernel's registers and spills, and its dynamic shared
    # memory (two q tiles, a 2-stage ring of K and V tiles, the mbarriers)
    sm90 = {n: r for n, r in ptxas_report(_build.build_log()).items()
            if "flash_attention_kernel_sm90" in n}
    assert len(sm90) == 2, list(sm90)
    for name, rep in sm90.items():
        d = int(re.search(r"sm90(?:<|ILi)(\d+)", name).group(1))
        smem = _build.library().repro_flash_attention_sm90_smem(d)
        log(f"[attention kernels] ptxas {name}: {rep}; dynamic shared "
            f"memory {smem} bytes")
        assert rep["spill_stores"] == 0 and rep["spill_loads"] == 0, rep

    # G1's prefill attention: one layer of one chunk of 16 prompts, timed
    # in turns (plain, kernel, library, kernel)
    B, S, H, HKV, D = CHUNK, G1_PROMPT, cfg.n_q, cfg.n_kv, cfg.d_head
    dt = torch.bfloat16
    q = torch.randn(B, S, H, D, device=DEVICE, generator=g).to(dt)
    k = torch.randn(B, S, HKV, D, device=DEVICE, generator=g).to(dt)
    v = torch.randn(B, S, HKV, D, device=DEVICE, generator=g).to(dt)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    plain = time_ms(lambda: flash_attention_ref(q, k, v, causal=True))
    ms_a = time_ms(lambda: flash_attention(q, k, v, causal=True))
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    ms_b = time_ms(lambda: flash_attention(q, k, v, causal=True))
    ms = (ms_a + ms_b) / 2
    ops = 4 * B * H * D * S * (S + 1) / 2
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    b_ops = 1e3 * ops / BF16_TC_OPS_PER_S
    b_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    log(f"[attention kernels] flash_attention G1 q {tuple(q.shape)} k/v "
        f"{tuple(k.shape)} bf16 causal: kernel {ms_a:.4f} / {ms_b:.4f} ms "
        f"(mean {ms:.4f}), plain {plain:.4f} ms, library "
        f"(scaled_dot_product_attention) {lib:.4f} ms, kernel / library "
        f"{ms / lib:.3f}; bound {b_ops:.4f} ms (operations: "
        f"{ops / 1e9:.2f} GFLOP at the bf16 tensor-core rate; bytes "
        f"{nbytes / 1e6:.1f} MB, {b_bytes:.4f} ms); achieved "
        f"{ops / ms / 1e9:.2f} TFLOP/s, {max(b_ops, b_bytes) / ms:.3f} of the"
        f" bound")
    return {"flash_attention": {
        "ms": ms, "plain_ms": plain, "library_ms": lib,
        "bound_ms": max(b_ops, b_bytes),
        "bound_by": "operations" if b_ops >= b_bytes else "bytes",
        "max_abs_err": err["bf16 vs plain"],
        "shape": f"q [{B}, {S}, {H}, {D}] k/v [{B}, {S}, {HKV}, {D}] bf16 "
                 f"causal"}}


def phase_attention_shapes() -> None:
    """The bf16 flash kernel beside the library call at shapes around G1's:
    its own S 1,024 without the causal mask, long rows (S 8,192, where a
    CTA's set-up and epilogue are amortised over 32 kv tiles on average),
    and d_head 64; each held against the plain version at 2e-2.  Where
    the kernel trails the library at G1's short rows but not at long ones,
    the gap is per work tile, not in the kv loop."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=DEVICE).manual_seed(1)
    # (B, S, H, Hkv, D, causal)
    for B, S, H, HKV, D, causal in [(16, 1024, 12, 2, 128, False),
                                    (2, 8192, 12, 2, 128, True),
                                    (2, 8192, 12, 2, 128, False),
                                    (16, 1024, 12, 2, 64, True)]:
        q, k, v = (torch.randn(B, S, h, D, device=DEVICE, generator=g)
                   .to(torch.bfloat16) for h in (H, HKV, HKV))
        a = flash_attention(q, k, v, causal=causal)
        b = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        diff = float((a.float() - b.float()).abs().max())
        assert diff <= 2e-2, (B, S, H, HKV, D, causal, diff)
        del a, b
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(lambda: flash_attention(q, k, v, causal=causal))
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        ops = 4 * B * H * D * (S * (S + 1) / 2 if causal else S * S)
        log(f"[attention shapes] q [{B}, {S}, {H}, {D}] k/v [{B}, {S}, {HKV}, "
            f"{D}] bf16 causal={causal}: kernel {ms:.4f} ms "
            f"({ops / ms / 1e9:.1f} TFLOP/s), library {lib:.4f} ms "
            f"({ops / lib / 1e9:.1f} TFLOP/s), kernel / library "
            f"{ms / lib:.3f}; max abs err vs plain {diff:.4f}")
    phase_attention_moe_shapes(g)


def _visible_pairs(S: int, chunk: int) -> int:
    """(query, key) pairs causal attention over S positions visits, within
    blocks of ``chunk`` positions (0: one block)."""
    c = chunk or S
    n, r = divmod(S, c)
    return n * c * (c + 1) // 2 + r * (r + 1) // 2


#: the MoE cells' prefill attention: (cell, B, S, H, Hkv, D, chunk, the
#: (batch, kv head) groups held against the plain version; None: all)
MOE_FLASH_SHAPES = [("G2", 16, 1024, 16, 16, 128, 0, None),
                    ("G3 chunked", 4, 16384, 40, 8, 128, 8192,
                     ((0, 0), (2, 3), (3, 7))),
                    ("G3 global", 4, 16384, 40, 8, 128, 0,
                     ((0, 0), (2, 3), (3, 7))),
                    ("M2, a rank of 2x2", 16, 32768, 8, 4, 128, 0,
                     ((0, 0), (8, 2), (15, 3)))]
#: an output row of N(0, 1) q/k/v averages the values of the keys it sees:
#: a row past a few thousand keys has an RMS near sqrt(e / keys), ~0.02 at
#: 8,192, so 2e-2 alone would pass a kernel that lost a kv tile there.
#: Each element is also held within its own bf16 rounding (2^-8 of itself)
#: plus four bf16 ulps (2^-5) of its row's RMS, for the rounding of P to
#: bf16 in the sums, against the plain version's fp32 result, and the
#: whole within 1e-2 relative: a kv tile of 128 keys lost or counted
#: twice moves a late row by about a tenth of its RMS
ROW_REL_TOL, REL_TOL = 2.0 ** -5, 1e-2


def attention_errors(a, ref32) -> tuple[float, float, float]:
    """(max abs error of ``a`` against the bf16 rounding of ``ref32``,
    ||a - ref32|| / ||ref32||, the largest element's |a - ref32| over
    2^-8 |ref32| + ROW_REL_TOL x its row's RMS: <= 1 passes), of attention
    outputs [..., D]."""
    import torch
    d = a.float() - ref32
    rms = ref32.square().mean(-1, keepdim=True).sqrt()
    allowed = 2.0 ** -8 * ref32.abs() + ROW_REL_TOL * rms
    return (float((a.float() - ref32.to(a.dtype).float()).abs().max()),
            float(torch.linalg.vector_norm(d) /
                  torch.linalg.vector_norm(ref32)),
            float((d.abs() / allowed.clamp_min(1e-30)).max()))


def phase_attention_moe_shapes(g) -> None:
    """The bf16 flash kernel at the MoE cells' prefill shapes, each held
    against the plain version and timed beside its bound, the plain
    version and the library call: G2's MHA q [16, 1024, 16, 128], G3's
    q [4, 16384, 40, 128] with k/v [4, 16384, 8, 128], chunk 8,192 (its
    chunked layers) and global (every fourth), and the call each rank of
    cell M2 makes on its local heads, q [16, 32768, 8, 128] with k/v
    [16, 32768, 4, 128] (phase M holds it there too; its kv groups pair
    2 q heads with a k/v head).  The check is 2e-2 absolute
    and, scale-aware, ``attention_errors`` (each element within its own
    rounding plus ROW_REL_TOL of its row's RMS, the whole within REL_TOL).
    At G3 the plain version's fp32 [S, T] scores of the whole call would
    take 172 GB, so it is held on kv groups (batch b, kv head j: q heads
    5j..5j+4 against k/v head j) and timed on one of the 32; the library
    call for a chunked layer is scaled_dot_product_attention with the
    boolean [S, T] mask, whose masked kernels take no GQA (k/v expanded to
    40 heads beforehand)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         flash_attention_ref)
    for cell, B, S, H, HKV, D, chunk, groups in MOE_FLASH_SHAPES:
        G = H // HKV
        q, k, v = (torch.randn(B, S, h, D, device=DEVICE, generator=g)
                   .to(torch.bfloat16) for h in (H, HKV, HKV))
        a = flash_attention(q, k, v, causal=True, chunk=chunk)

        def group(b, j):
            """(q, k, v, out) of batch b and kv head j, or all (None)."""
            if b is None:
                return q, k, v, a
            h = slice(G * j, G * j + G)
            return (q[b:b + 1, :, h], k[b:b + 1, :, j:j + 1],
                    v[b:b + 1, :, j:j + 1], a[b:b + 1, :, h])

        diff = rel = row = 0.0
        for b, j in groups or [(None, None)]:
            gq, gk, gv, ga = group(b, j)
            # the plain version's fp32 result on the bf16 inputs
            ref = flash_attention_ref(gq.float(), gk.float(), gv.float(),
                                      causal=True, chunk=chunk)
            e = attention_errors(ga, ref)
            diff, rel, row = max(diff, e[0]), max(rel, e[1]), max(row, e[2])
            del ref
        assert diff <= 2e-2 and rel <= REL_TOL and row <= 1.0, \
            (cell, diff, rel, row)
        pq, pk, pv, _ = group(*((0, 0) if groups else (None, None)))
        plain = time_ms(lambda: flash_attention_ref(pq, pk, pv, causal=True,
                                                    chunk=chunk), iters=3)
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True,
                                             chunk=chunk))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if chunk:
            mask = attention_mask(S, S, causal=True, chunk=chunk,
                                  device=q.device)
            kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2)
                      for x in (k, v))

            def library():
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                                  SDPBackend.CUDNN_ATTENTION]):
                    return F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=mask)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=G > 1)
        lib = time_ms(library)
        ops = 4 * B * H * D * _visible_pairs(S, chunk)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_ops = 1e3 * ops / BF16_TC_OPS_PER_S
        b_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        log(f"[attention shapes] {cell}: q [{B}, {S}, {H}, {D}] k/v [{B}, "
            f"{S}, {HKV}, {D}] bf16 causal chunk={chunk}: kernel {ms:.4f} ms"
            f" ({ops / ms / 1e9:.1f} TFLOP/s), library {lib:.4f} ms, kernel "
            f"/ library {ms / lib:.3f}; plain "
            f"{'(one of ' + str(B * HKV) + ' kv groups) ' if groups else ''}"
            f"{plain:.4f} ms; bound {max(b_ops, b_bytes):.4f} ms "
            f"({'operations' if b_ops >= b_bytes else 'bytes'}: "
            f"{ops / 1e9:.1f} GFLOP, {b_ops:.4f} ms; {nbytes / 1e6:.1f} MB, "
            f"{b_bytes:.4f} ms), {max(b_ops, b_bytes) / ms:.3f} of it; max "
            f"abs err vs plain {diff:.4f}, relative {rel:.3e}, worst "
            f"element {row:.3f} of its allowance (2^-8 of itself + "
            f"{ROW_REL_TOL} of its row's RMS) "
            f"{'on kv groups ' + str(groups) if groups else ''}")
        del q, k, v, a, qt, kt, vt
        torch.cuda.empty_cache()


def phase_generate(index, forms, state) -> dict:
    """Cell G1: the RAG answer stage at full width on the 250 T topics
    through ``Experiment(measure_time=True)``, the greedy decode of each
    chunk one captured CUDA graph; reads the launch counters right after
    it, then times one chunk's prefill and decode apart, eagerly and as
    captured graphs (whose tokens must equal the eager run's bit for bit),
    and runs the einsum attention path on the same weights."""
    import dataclasses
    import torch
    import repro_torch as rt
    from repro_torch.configs import qwen2_1_5b
    from repro_torch.core import Context, StageProgram, ir
    from repro_torch.core.stages import greedy_generate_fn
    from repro_torch.models import transformer_lm as tlm
    cfg = dataclasses.replace(qwen2_1_5b.model_cfg(), attn_impl="pallas")
    be = rt.TorchBackend(index, state["dense"], default_k=1000,
                         bucket_ladder=LADDER, device=DEVICE)
    t0 = time.perf_counter()
    be.register_lm(cfg.name, cfg, seed=0)
    torch.cuda.synchronize()
    lm = be.lm(cfg.name)[1]
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"[generate] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_q}/{cfg.n_kv} heads of {cfg.d_head}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters in "
        f"{cfg.dtype} drawn on the card from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s")

    def generate(model):
        return rt.Generate(model, max_new_tokens=G1_NEW,
                           max_prompt_len=G1_PROMPT, prompt_docs=G1_DOCS)

    def rag(model):
        return (rt.Retrieve("BM25") >> rt.DenseRerank() % G1_DEPTH
                >> generate(model))

    pipe = rag(cfg.name)
    report = {}
    op = compile_checked(pipe, be, report=report)
    kinds = [o.kind for o in ir.chain(op)]
    assert kinds == ["fused_dense_rerank", "generate"], kinds
    log(f"[generate] compile report: chain {kinds}; fusion decisions "
        f"{report['fusion_decisions']}; passes "
        f"{[(n, round(1e3 * s, 3)) for n, s in report['pass_timings_s']]} ms")
    topics = forms["T"]
    Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                        device=DEVICE)
    nq = len(topics.qids)

    # the main path: counts from zero, read right after the Experiment
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = rt.Experiment([pipe], Q, topics.qrels, ["map", "ndcg_cut_10"],
                        backend=be, measure_time=True)
    launches = read_launches("flash_attention", "dense_topk")
    row, A = res["table"][0], res["results"][0]
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] G1 {time.perf_counter() - t0:.1f} s (warm-up + timed run);"
        f" launches (device: runs on the card, counted by the kernels; "
        f"host: counted by the wrappers, eager or recorded into a capture) "
        f"{launches}; flash's expected device count is 28 layers x (16 "
        f"chunks x 2 runs of the captured graph + the warm-up run before "
        f"its capture) = 924, host 28 x 2 = 56; graph captures by cause "
        f"{be.engine.compiles_by_cause()}; peak device memory {peak} bytes")
    for name, c in launches.items():
        assert c["device"] > 0, f"kernel {name} did not run on the G1 path"
    tokens = A["tokens"]
    assert tokens.shape == (nq, G1_NEW) and tokens.dtype == torch.int32
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab
    assert A["docids"].shape == (nq, G1_DEPTH)
    log(f"[generate] G1 mrt_ms {row['mrt_ms']:.4f} per query (250 T topics,"
        f" chunks of {CHUNK}); map {row['map']:.4f} ndcg_cut_10 "
        f"{row['ndcg_cut_10']:.4f} of the reranked depth {G1_DEPTH}; "
        f"tokens {tuple(tokens.shape)} in [{int(tokens.min())}, "
        f"{int(tokens.max())}], {len(torch.unique(tokens))} distinct")

    # prefill and decode of one chunk, timed apart
    Q16 = {key: val[:CHUNK] for key, val in Q.items()}
    prompts = generate(cfg.name).assemble(Context(be), Q16,
                                          {"docids": A["docids"][:CHUNK]})
    P = G1_PROMPT + G1_NEW
    times = {"prefill": [], "decode": []}
    for _ in range(3):
        cache = tlm.init_kv_cache(cfg, CHUNK, P, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tlm.prefill(cfg, lm, prompts, cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = torch.argmax(logits, -1).to(torch.int32)
        eager = [tok]
        for t in range(G1_NEW - 1):
            logits, cache = tlm.decode_step(cfg, lm, tok[:, None], cache,
                                            G1_PROMPT + t)
            tok = torch.argmax(logits, -1).to(torch.int32)
            eager.append(tok)
        torch.cuda.synchronize()
        times["prefill"].append(t1 - t0)
        times["decode"].append(time.perf_counter() - t1)
    pre, dec = min(times["prefill"]), min(times["decode"])
    log(f"[generate] one chunk of {CHUNK}, eager (best of 3): prefill "
        f"{1e3 * pre:.2f} ms = {CHUNK * G1_PROMPT / pre:.0f} tokens/s; "
        f"{G1_NEW - 1} decode steps {1e3 * dec:.2f} ms = "
        f"{1e3 * dec / (G1_NEW - 1):.3f} ms/step = "
        f"{CHUNK * (G1_NEW - 1) / dec:.0f} tokens/s")
    # the same program as captured graphs: G1's (prefill + every decode
    # step, the Experiment's entry), and the decode steps alone, whose
    # cache the program updates in place
    eager = torch.stack(eager, dim=1)
    assert torch.equal(A["tokens"][:CHUNK], eager), \
        "G1's tokens through the captured graph differ from the eager run"
    gen_prog = StageProgram(key=(be.uid, generate(cfg.name).key(),
                                 "generate"), fn=greedy_generate_fn(
        cfg, max_prompt_len=G1_PROMPT, max_new_tokens=G1_NEW))

    def decode_all(lm, tok, cache):
        for t in range(G1_NEW - 1):
            logits, cache = tlm.decode_step(cfg, lm, tok[:, None], cache,
                                            G1_PROMPT + t)
            tok = torch.argmax(logits, -1).to(torch.int32)
        return tok, cache

    dec_prog = StageProgram(key=("g1 decode steps",), fn=decode_all)
    cache = tlm.init_kv_cache(cfg, CHUNK, P, device=DEVICE)
    tok0 = torch.argmax(tlm.prefill(cfg, lm, prompts, cache)[0],
                        -1).to(torch.int32)
    be.engine.run_pinned(dec_prog, lm, tok0, cache, donate_argnums=(2,))
    # the chunk's count of real rows, as Generate passes it: the same entry
    n_real = torch.full((), prompts.shape[0], dtype=torch.long,
                        device=DEVICE)
    g_times = {"program": [], "decode": []}
    for _ in range(3):
        for name, call in (
                ("program", lambda: be.engine.run_pinned(gen_prog, lm,
                                                         prompts, n_real)),
                ("decode", lambda: be.engine.run_pinned(
                    dec_prog, lm, tok0, cache, donate_argnums=(2,)))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            g_times[name].append(time.perf_counter() - t0)
            if name == "program":
                assert torch.equal(out, eager)
    g_prog, g_dec = min(g_times["program"]), min(g_times["decode"])
    log(f"[generate] one chunk of {CHUNK}, captured graphs (best of 3): "
        f"prefill + {G1_NEW - 1} decode steps {1e3 * g_prog:.2f} ms (eager "
        f"{1e3 * (pre + dec):.2f} ms), tokens bit-equal to the eager run; "
        f"{G1_NEW - 1} decode steps alone {1e3 * g_dec:.2f} ms = "
        f"{1e3 * g_dec / (G1_NEW - 1):.3f} ms/step (eager "
        f"{1e3 * dec / (G1_NEW - 1):.3f}) = "
        f"{CHUNK * (G1_NEW - 1) / g_dec:.0f} tokens/s")

    # the einsum attention path on the card, same weights
    cfg_x = dataclasses.replace(cfg, attn_impl="xla")
    be.register_lm("qwen2-1.5b-einsum", cfg_x, lm)
    Ax = rt.run_pipeline(rag("qwen2-1.5b-einsum"), Q, backend=be)
    docs = float((Ax["docids"] == A["docids"]).all(1).float().mean())
    first = float((Ax["tokens"][:, 0] == tokens[:, 0]).float().mean())
    whole = float((Ax["tokens"] == tokens).all(1).float().mean())
    same = (Ax["tokens"] == tokens).float().mean(0)
    log(f"[generate] flash kernel vs einsum path ({docs:.4f} of the topics "
        f"with equal docids): first token agrees on {first:.4f} of {nq} "
        f"topics, all {G1_NEW} tokens on {whole:.4f}; "
        f"per-step agreement {[round(float(x), 3) for x in same]}")
    # where the first tokens differ: both paths' prefill logits of those
    # prompts, the gap between the two tokens on each side
    rows = (Ax["tokens"][:, 0] != tokens[:, 0]).nonzero()[:, 0][:CHUNK]
    if len(rows):
        Qd = {key: val[rows] for key, val in Q.items()}
        pd = generate(cfg.name).assemble(Context(be), Qd,
                                         {"docids": A["docids"][rows]})
        tk, tx = tokens[rows, 0].long(), Ax["tokens"][rows, 0].long()
        gaps = []
        for c in (cfg, cfg_x):
            cache = tlm.init_kv_cache(c, len(rows), G1_PROMPT, device=DEVICE)
            lg = tlm.prefill(c, lm, pd, cache)[0].float()
            own, other = (tk, tx) if c is cfg else (tx, tk)
            ar = torch.arange(len(rows), device=lg.device)
            gaps.append((lg[ar, own] - lg[ar, other]).tolist())
        log(f"[generate] the {len(rows)} first-token flips: logit gap "
            f"between the two tokens, kernel path {gaps[0]}, einsum path "
            f"{gaps[1]} (bf16 logits; spacing 0.5 in [64, 128), 1 in "
            f"[128, 256))")
    assert first >= G1_FIRST_TOKEN_MIN, first
    return {"launches": launches, "cfg": cfg, "lm": lm, "tokens": tokens,
            "docids": A["docids"]}


def phase_moe_layers() -> None:
    """One full-width OLMoE-1B-7B and one Llama-4-Scout MoE layer (weights
    drawn on the card from seed 0), 64 tokens each, on the card and on
    the CPU with the same weights and inputs: the experts picked agree but
    where the top-k margin lies within a bf16 rounding of the scores; the
    outputs of the tokens routed alike agree within 3 % of the largest
    magnitude (the bf16 rule); with room for every assignment, scatter and
    einsum dispatch agree on the card by the same rule; and the gradients
    of sum(out^2) + moe_aux + moe_z, routes pinned to the card's, agree on
    every parameter (router, experts, shared expert) by the same rule."""
    import importlib
    import torch
    from repro_torch.models import moe
    for mod in ("olmoe_1b_7b", "llama4_scout_17b_a16e"):
        cfg = importlib.import_module(f"repro_torch.configs.{mod}").model_cfg()
        m = cfg.moe
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        p = moe.moe_init(gen, cfg.d_model, m, cfg.dtype)
        x = torch.randn(1, 64, cfg.d_model, device=DEVICE,
                        generator=gen).to(cfg.dtype)
        t0 = time.perf_counter()
        p_cpu = moe.MoE(cfg.d_model, m, cfg.dtype, "cpu")
        p_cpu.load_state_dict(p.state_dict())
        out = {}
        for dev, pp in (("card", p), ("cpu", p_cpu)):
            xx = x.to(dev if dev == "cpu" else DEVICE)
            xt = xx.reshape(64, cfg.d_model)
            gates, idx, _ = moe._routing(xt, pp.router, m)
            scores = xt.float() @ pp.router
            scores = (torch.sigmoid(scores) if m.router_act == "sigmoid"
                      else torch.softmax(scores, -1))
            out[dev] = (moe.moe_apply(pp, xx, m)[0].float().cpu(),
                        idx.cpu(), scores.cpu())
        cpu_s = time.perf_counter() - t0
        (o_c, i_c, s_c), (o_h, i_h, s_h) = out["card"], out["cpu"]
        same = (i_c.sort(-1).values == i_h.sort(-1).values).all(-1)
        # a token whose picks differ: its k-th and (k+1)-th scores within
        # a bf16 rounding (2^-8 relative) on the card's side
        top = s_c.sort(-1, descending=True).values
        margin = top[:, m.top_k - 1] - top[:, m.top_k]
        tie = margin <= top[:, m.top_k - 1].abs() * 2.0 ** -8
        assert bool((same | tie).all()), (mod, (~same).nonzero().tolist())
        scale = float(o_h[0, same].abs().max())
        d_out = float((o_c[0, same] - o_h[0, same]).abs().max())
        assert d_out <= 0.03 * scale, (mod, d_out, scale)
        # scatter vs einsum on the card, nothing dropped
        room = dataclasses.replace(m, capacity_factor=float(m.n_experts))
        a = moe.moe_apply(p, x, room)[0].float()
        b = moe.moe_apply(p, x, dataclasses.replace(room,
                                                    dispatch="einsum"))[0]
        torch.cuda.synchronize()
        d_disp = float((a - b.float()).abs().max())
        assert d_disp <= 0.03 * float(a.abs().max()), (mod, d_disp)
        t0 = time.perf_counter()
        grads = {dev: moe_layer_grads(pp, x.to(pp.router.device), m,
                                      i_c.to(pp.router.device))
                 for dev, pp in (("card", p), ("cpu", p_cpu))}
        d_grad = {}
        for name, g in grads["card"].items():
            want = grads["cpu"][name].to(DEVICE).float()
            scale = float(want.abs().max())
            d_grad[name] = float((g.float() - want).abs().max()) / scale
            assert bool(torch.isfinite(g).all()) and scale > 0, (mod, name)
            assert d_grad[name] <= 0.03, (mod, name, d_grad[name])
        grad_s = time.perf_counter() - t0
        log(f"[moe layers] {cfg.name}: {m.n_experts} experts of d_ff "
            f"{m.d_ff_expert}, top-{m.top_k} {m.router_act}"
            f"{', 1 shared expert' if m.n_shared else ''}, d_model "
            f"{cfg.d_model}, 64 tokens: experts picked alike on card and "
            f"CPU for {float(same.float().mean()):.4f} of the tokens (the "
            f"rest within a bf16 rounding of the top-k margin); their outputs"
            f" within {d_out:.4g} of each other (largest {scale:.4g}); "
            f"scatter vs einsum dispatch on the card {d_disp:.4g} (largest "
            f"{float(a.abs().max()):.4g}); CPU side {cpu_s:.2f} s; "
            f"gradients card vs CPU, routes pinned, largest difference over "
            f"largest magnitude per parameter "
            f"{ {n: round(v, 5) for n, v in d_grad.items()} } (<= 0.03), "
            f"{grad_s:.2f} s")
        del p, p_cpu, x, a, b, grads
        torch.cuda.empty_cache()


def moe_layer_grads(p, x, cfg, expert_idx) -> dict:
    """The gradients of sum(out^2) + moe_aux + moe_z of one MoE layer with
    its routes pinned to ``expert_idx``, by parameter name; the layer's
    parameters require grad only inside."""
    import torch
    from repro_torch.models import moe
    p.requires_grad_(True)
    try:
        out, met = moe.moe_apply(p, x, cfg, expert_idx=expert_idx)
        loss = out.float().square().sum() + met["moe_aux"] + met["moe_z"]
        names = [n for n, _ in p.named_parameters()]
        return dict(zip(names, torch.autograd.grad(loss,
                                                   list(p.parameters()))))
    finally:
        p.requires_grad_(False)


def attention_layer_by_layer(cfg, lm, prompts) -> list:
    """The kernel path's prefill of ``prompts`` walked layer by layer: at
    each layer's input, its attention sublayer on the flash kernel and on
    the einsum path, and the experts the next MoE picks after each.  Per
    layer: (chunk, max abs difference of the two attention outputs, their
    largest magnitude, share of tokens whose experts both pick alike)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models import transformer_lm as tlm
    x = lm.embed.to(cfg.dtype)[prompts.long()]
    positions = torch.arange(prompts.shape[1], device=x.device)
    memo = {"pallas": {}, "xla": {}}
    rows = []
    for blk, chunk in zip(lm.layers, tlm._layer_chunks(cfg)):
        h = L.rmsnorm(x, blk.ln_attn, cfg.norm_eps)
        a = {impl: L.attn_apply(blk.attn, h, positions=positions, chunk=chunk,
                                impl=impl, memo=memo[impl])
             for impl in memo}
        picks = [moe._routing(L.rmsnorm(x + a[impl], blk.ln_mlp, cfg.norm_eps)
                              .reshape(-1, cfg.d_model), blk.moe.router,
                              cfg.moe)[1].sort(-1).values for impl in memo]
        rows.append((chunk, float((a["pallas"].float() - a["xla"].float())
                                  .abs().max()),
                     float(a["xla"].float().abs().max()),
                     float((picks[0] == picks[1]).all(-1).float().mean())))
        x = tlm._block(cfg, blk, x, lambda attn, h, out=a["pallas"]: out)
        del a, picks, h
    return rows


def plain_attention(q, k, v, *, causal: bool = True, chunk: int = 0):
    """The flash kernel's plain version (fp32 scores, P and P V), on one kv
    group (batch b, kv head j) at a time where the whole call's fp32
    scores would pass 4 GiB."""
    import torch
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, S, H, D = q.shape
    T, HKV = k.shape[1], k.shape[2]
    if B * H * S * T * 4 <= 4 << 30:
        return flash_attention_ref(q, k, v, causal=causal, chunk=chunk)
    G = H // HKV
    out = torch.empty_like(q)
    for b in range(B):
        for j in range(HKV):
            h = slice(G * j, G * j + G)
            out[b:b + 1, :, h] = flash_attention_ref(
                q[b:b + 1, :, h], k[b:b + 1, :, j:j + 1],
                v[b:b + 1, :, j:j + 1], causal=causal, chunk=chunk)
    return out


#: the walk's ways: (attention, routes pinned to the einsum path's);
#: "flash" the kernel, "plain" its plain version in place of it
WALK = {"einsum": ("xla", False), "kernel": ("flash", False),
        "kernel pinned": ("flash", True), "plain": ("plain", False),
        "plain pinned": ("plain", True)}


def walk_routes(cfg, lm, prompts, n_rows: int):
    """The prefill of ``prompts`` [C, P] (the first ``n_rows`` real, the
    rest zero rows padding the bucket, as the engine runs a chunk) walked
    layer by layer without a cache, each way of ``WALK``: the einsum
    attention path; the flash kernel routing on its own (the main path's
    function) and with each MoE layer routed to the experts the einsum
    path picks at that layer; and the same two with the kernel's plain
    version in its place, a second equally correct attention beside the
    einsum path's.  Returns ({way: last-position logits [C, vocab]},
    {way: per layer the share of real tokens whose experts it picks as the
    einsum path does})."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer_lm as tlm
    x0 = lm.embed.to(cfg.dtype)[prompts.long()]
    xs = dict.fromkeys(WALK, x0)
    positions = torch.arange(prompts.shape[1], device=x0.device)
    memo = {"xla": {}, "pallas": {}}
    rows = torch.full((), n_rows, dtype=torch.long, device=x0.device)
    real = n_rows * prompts.shape[1]
    alike = {way: [] for way in WALK}
    kernel = L.flash_attention
    try:
        for blk, chunk in zip(lm.layers, tlm._layer_chunks(cfg)):
            met = {}
            for way, (attn_by, pinned) in WALK.items():
                im = "xla" if attn_by == "xla" else "pallas"
                L.flash_attention = (plain_attention if attn_by == "plain"
                                     else kernel)

                def attend(attn, h, im=im, chunk=chunk):
                    return L.attn_apply(attn, h, positions=positions,
                                        chunk=chunk, impl=im, memo=memo[im])
                route = {"n_rows": rows}
                if pinned:
                    route["expert_idx"] = met["einsum"][0]["expert_idx"]
                met[way] = []
                xs[way] = tlm._block(cfg, blk, xs[way], attend, met[way],
                                     **route)
                same = (met[way][0]["expert_idx"].sort(-1).values ==
                        met["einsum"][0]["expert_idx"].sort(-1).values)
                alike[way].append(float(same.all(-1)[:real].float().mean()))
    finally:
        L.flash_attention = kernel
    return ({way: tlm._last_logits(cfg, lm, x) for way, x in xs.items()},
            alike)


def phase_generate_moe(index, forms, state, cell: RagCell) -> dict:
    """A RAG cell on an MoE LM (G2, G3) through ``Experiment(measure_time=
    True)``, each chunk's greedy decode one captured CUDA graph: launches
    read right after it (flash: layers x (chunks x 2 runs of the graph +
    the warm-up before its capture)); the first chunk run again eagerly
    with its routing recorded (load per expert, dropped share at prefill
    and decode), its tokens bit-equal to the graph's; the captured
    program and decode steps timed; with ``pool_slots`` a decode pool of
    captured graphs over the first chunk's prompts; then the einsum
    attention path on the same weights: layer by layer on the first chunk
    from the kernel path's inputs, each layer's attention output within 3 %
    of its largest magnitude (the bf16 rule) and the share of tokens whose
    experts the two outputs pick alike printed; then end to end on
    ``einsum_topics``, its first-token agreement printed; then the witness
    of what that agreement measures (``walk_routes``): the same prefills
    on the kernel, routing freely (first tokens equal to the
    Experiment's) and pinned to the einsum path's routes, each beside the
    kernel's plain version in its place, and held to agree with the
    einsum path no less often than the plain version does.  The
    end-to-end agreement is not held to G1's 0.95: routing is
    discontinuous, so rounding-level differences pick other experts for
    some tokens, and attention carries their states to every later
    position, whichever of two correct attentions runs."""
    import importlib
    import torch
    import repro_torch as rt
    from repro_torch.core import Context, StageProgram, ir
    from repro_torch.core.stages import greedy_generate_fn
    from repro_torch.models import moe
    from repro_torch.models import transformer_lm as tlm
    from repro_torch.serve.batching import ContinuousBatcher, Request
    tag = f"[{cell.name}]"
    full = importlib.import_module(
        f"repro_torch.configs.{cell.config}").model_cfg()
    cfg = dataclasses.replace(full, attn_impl="pallas",
                              n_layers=cell.layers or full.n_layers)
    m = cfg.moe
    be = rt.TorchBackend(index, state["dense"], default_k=1000,
                         bucket_ladder=(cell.chunk,), device=DEVICE)
    t0 = time.perf_counter()
    be.register_lm(cfg.name, cfg, seed=0)
    torch.cuda.synchronize()
    lm = be.lm(cfg.name)[1]
    n_params = sum(p.numel() for p in lm.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    elt = lm.embed.element_size()
    # a decode step needs every weight but the embedding table's unused
    # rows and the routed experts its tokens do not pick, and the KV cache
    # up to each step's position (P + new / 2 on average)
    expert_bytes = 3 * cfg.d_model * m.d_ff_expert * elt
    base_bytes = w_bytes - lm.embed.numel() * elt * \
        (not cfg.tie_embeddings) - cfg.n_layers * m.n_experts * \
        expert_bytes + 2 * cfg.n_layers * cell.chunk * \
        (cell.prompt + cell.new / 2) * cfg.n_kv * cfg.d_head * elt
    log(f"{tag} {cfg.name}: {cfg.n_layers} of {full.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_q}/{cfg.n_kv} heads of {cfg.d_head},"
        f" {m.n_experts} experts of d_ff {m.d_ff_expert} top-{m.top_k} "
        f"({m.router_act}{', 1 shared expert' if m.n_shared else ''}), "
        f"vocab {cfg.vocab}, rope theta {cfg.rope_theta}, chunk "
        f"{cfg.attn_chunk} every {cfg.attn_chunk_every}: {n_params} "
        f"parameters, {w_bytes} bytes in {cfg.dtype}, drawn on the card "
        f"from seed 0 in {time.perf_counter() - t0:.2f} s")

    def generate(model):
        return rt.Generate(model, max_new_tokens=cell.new,
                           max_prompt_len=cell.prompt, prompt_docs=cell.docs)

    def rag(model):
        return (rt.Retrieve("BM25") >> rt.DenseRerank() % cell.depth
                >> generate(model))

    pipe = rag(cfg.name)
    kinds = [o.kind for o in ir.chain(compile_checked(pipe, be))]
    assert kinds == ["fused_dense_rerank", "generate"], kinds
    topics = forms["T"]
    nq = cell.topics or len(topics.qids)
    Q = rt.make_queries(topics.terms[:nq], topics.weights[:nq],
                        topics.qids[:nq], device=DEVICE)
    n_chunks, P, C = -(-nq // cell.chunk), cell.prompt, cell.chunk

    # the main path: counts from zero, read right after the Experiment
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = rt.Experiment([pipe], Q, topics.qrels, ["map", "ndcg_cut_10"],
                        backend=be, measure_time=True)
    launches = read_launches("flash_attention", "dense_topk")
    row, A = res["table"][0], res["results"][0]
    want_flash = cfg.n_layers * (2 * n_chunks + 1)
    log(f"[main] {cell.name} {time.perf_counter() - t0:.1f} s (warm-up + "
        f"timed run); launches {launches}; flash's expected device count "
        f"{cfg.n_layers} layers ({sum(map(bool, tlm._layer_chunks(cfg)))} "
        f"chunked at {cfg.attn_chunk}, the rest global) x ({n_chunks} chunks"
        f" x 2 runs of the captured graph + the warm-up run) = {want_flash};"
        f" graph captures by cause {be.engine.compiles_by_cause()}; peak "
        f"device memory {torch.cuda.max_memory_allocated()} bytes")
    assert launches["flash_attention"]["device"] == want_flash, launches
    assert launches["dense_topk"]["device"] > 0, launches
    tokens = A["tokens"]
    assert tokens.shape == (nq, cell.new) and tokens.dtype == torch.int32
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab
    assert A["docids"].shape == (nq, cell.depth)
    log(f"{tag} mrt_ms {row['mrt_ms']:.4f} per query ({nq} T topics, chunks"
        f" of {C}, prompts of {P}); map {row['map']:.4f} ndcg_cut_10 "
        f"{row['ndcg_cut_10']:.4f} of the reranked depth {cell.depth}; "
        f"tokens {tuple(tokens.shape)} in [{int(tokens.min())}, "
        f"{int(tokens.max())}], {len(torch.unique(tokens))} distinct")

    # the first chunk eagerly, each MoE call's metrics kept: its routing
    Qc = {key: val[:C] for key, val in Q.items()}
    prompts = generate(cfg.name).assemble(Context(be),
                                          Qc, {"docids": A["docids"][:C]})
    routed = {"prefill": [], "decode": []}
    cache = tlm.init_kv_cache(cfg, C, P + cell.new, device=DEVICE)
    logits, cache = tlm.prefill(cfg, lm, prompts, cache,
                                metrics=routed["prefill"])
    tok = torch.argmax(logits, -1).to(torch.int32)
    eager = [tok]
    for t in range(cell.new - 1):
        logits, cache = tlm.decode_step(cfg, lm, tok[:, None], cache, P + t,
                                        metrics=routed["decode"])
        tok = torch.argmax(logits, -1).to(torch.int32)
        eager.append(tok)
    eager = torch.stack(eager, dim=1)
    assert torch.equal(A["tokens"][:C], eager), \
        f"{cell.name}'s tokens through the captured graph differ from eager"
    for when, mets in routed.items():
        load = torch.stack([x["expert_load"] for x in mets]).sum(0).tolist()
        dropped = int(sum(x["dropped"] for x in mets))
        n_assign = sum(x["expert_idx"].numel() for x in mets)
        steps = len(mets) // cfg.n_layers
        cap = moe.scatter_capacity(m, C, P if when == "prefill" else 1)
        log(f"{tag} routing at {when} (first chunk, {len(mets)} calls: "
            f"{cfg.n_layers} layers x {steps} steps; capacity {cap} slots "
            f"an expert a call): {dropped} of {n_assign} assignments "
            f"dropped ({dropped / n_assign:.4f}); load per expert over the "
            f"calls, min {min(load)} max {max(load)}: {load}")
    # the routed experts a decode step reaches: a layer's distinct picks
    hit = sum(int((x["expert_load"] > 0).sum()) for x in routed["decode"])
    hit_per_step = hit / (len(routed["decode"]) // cfg.n_layers)
    del cache, logits, routed

    # the captured graphs: the Experiment's program (prefill + every
    # decode step, its entry for this rung) and the decode steps alone,
    # best of 3
    gen_prog = StageProgram(key=(be.uid, generate(cfg.name).key(),
                                 "generate"), fn=greedy_generate_fn(
        cfg, max_prompt_len=P, max_new_tokens=cell.new))

    def decode_all(lm, tok, cache):
        for t in range(cell.new - 1):
            logits, cache = tlm.decode_step(cfg, lm, tok[:, None], cache,
                                            P + t)
            tok = torch.argmax(logits, -1).to(torch.int32)
        return tok, cache

    dec_prog = StageProgram(key=(cell.name, "decode steps"), fn=decode_all)
    cache = tlm.init_kv_cache(cfg, C, P + cell.new, device=DEVICE)
    tok0 = torch.argmax(tlm.prefill(cfg, lm, prompts, cache)[0],
                        -1).to(torch.int32)
    be.engine.run_pinned(dec_prog, lm, tok0, cache, donate_argnums=(2,))
    # the chunk's count of real rows, as Generate passes it: the same entry
    n_real = torch.full((), prompts.shape[0], dtype=torch.long,
                        device=DEVICE)
    g_times = {"program": [], "decode": []}
    for _ in range(3):
        for name, call in (
                ("program", lambda: be.engine.run_pinned(gen_prog, lm,
                                                         prompts, n_real)),
                ("decode", lambda: be.engine.run_pinned(
                    dec_prog, lm, tok0, cache, donate_argnums=(2,)))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            g_times[name].append(time.perf_counter() - t0)
            if name == "program":
                assert torch.equal(out, eager)
    g_prog, g_dec = min(g_times["program"]), min(g_times["decode"])
    steps = cell.new - 1
    step_bytes = base_bytes + hit_per_step * expert_bytes
    all_bytes = base_bytes + cfg.n_layers * m.n_experts * expert_bytes
    log(f"{tag} one chunk of {C}, captured graphs (best of 3): prefill + "
        f"{steps} decode steps {1e3 * g_prog:.2f} ms, tokens bit-equal to "
        f"the eager run; {steps} decode steps alone {1e3 * g_dec:.2f} ms = "
        f"{1e3 * g_dec / steps:.3f} ms/step = {C * steps / g_dec:.0f} "
        f"tokens/s; prefill ~{1e3 * (g_prog - g_dec):.2f} ms = "
        f"{C * P / (g_prog - g_dec):.0f} tokens/s; a step needs "
        f"{step_bytes / 1e9:.2f} GB: bound "
        f"{1e3 * step_bytes / HBM_BYTES_PER_S:.3f} ms/step, "
        f"{1e3 * g_dec / steps / (1e3 * step_bytes / HBM_BYTES_PER_S):.3f}"
        f"x it (the weights but the embedding table's unused rows and the "
        f"routed experts no token picks: {hit_per_step / cfg.n_layers:.2f} "
        f"of {m.n_experts} a layer on this run's steps, at most "
        f"{min(m.n_experts, C * m.top_k)}; the KV cache to each position); "
        f"the scatter dispatch's products read all {m.n_experts} experts, "
        f"{all_bytes / 1e9:.2f} GB, "
        f"{1e3 * all_bytes / HBM_BYTES_PER_S:.3f} ms/step")
    del cache, tok0, out

    windows = [launches]
    if cell.pool_slots:
        # the decode pool on the same LM: the first chunk's prompts as
        # requests, the slot prefill and the ragged step captured graphs
        pool = ContinuousBatcher(cfg, lm, slots=cell.pool_slots,
                                 max_len=P + cell.new + 1, engine=be.engine,
                                 key=(cell.name, "pool"))
        before = dict(be.engine.compiles_by_cause())
        zero_launches()
        t0 = time.perf_counter()
        for i, prompt in enumerate(prompts.cpu().numpy()):
            pool.submit(Request(rid=i, prompt=prompt,
                                max_new_tokens=cell.new))
        done = pool.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pl = read_launches("flash_attention")
        windows.append(pl)
        assert len(done) == C and all(
            len(r.generated) == cell.new and
            0 <= min(r.generated) and max(r.generated) < cfg.vocab
            for r in done), [len(r.generated) for r in done]
        want_pool = cfg.n_layers * (C + 1)
        log(f"[main] {cell.name} pool: {C} requests in {cell.pool_slots} "
            f"slots, {pool.n_decode_steps} ragged steps, {wall:.2f} s "
            f"({1e3 * wall / pool.n_decode_steps:.3f} ms a step, slot "
            f"prefills included); launches {pl}, flash's expected device "
            f"count {cfg.n_layers} layers x ({C} slot prefills + the "
            f"warm-up) = {want_pool} (the ragged step is on the einsum "
            f"path); graph captures {before} -> "
            f"{be.engine.compiles_by_cause()}")
        assert pl["flash_attention"]["device"] == want_pool, pl
        del pool, done

    # the einsum attention path on the same weights and chunks (an MoE
    # call's capacity counts its batch), once the kernel path's graphs and
    # their memory pools are gone: first layer by layer on the first
    # chunk's prompts, each layer's attention from the kernel path's input
    del be, res, gen_prog, dec_prog
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    layers = attention_layer_by_layer(cfg, lm, prompts)
    log(f"{tag} layer by layer on the first chunk ({time.perf_counter() - t0:.1f}"
        f" s): per layer (chunk, max abs diff kernel vs einsum attention "
        f"output, largest magnitude, share of tokens whose {m.top_k} experts"
        f" are picked alike after each): "
        f"{[(c, round(d, 4), round(a, 2), round(r, 4)) for c, d, a, r in layers]}")
    for c, d, a, _ in layers:
        assert d <= 0.03 * a, (cell.name, c, d, a)
    cfg_x = dataclasses.replace(cfg, attn_impl="xla")
    bx = rt.TorchBackend(index, state["dense"], default_k=1000,
                         bucket_ladder=(C,), device=DEVICE)
    bx.register_lm(f"{cfg.name}-einsum", cfg_x, lm)
    t0 = time.perf_counter()
    ne = cell.einsum_topics or nq
    Ax = rt.run_pipeline(rag(f"{cfg.name}-einsum"),
                         {key: val[:ne] for key, val in Q.items()}, backend=bx)
    torch.cuda.synchronize()
    docs = float((Ax["docids"] == A["docids"][:ne]).all(1).float().mean())
    agree = Ax["tokens"][:, 0] == tokens[:ne, 0]
    first = float(agree.float().mean())
    whole = float((Ax["tokens"] == tokens[:ne]).all(1).float().mean())
    same = (Ax["tokens"] == tokens[:ne]).float().mean(0)
    log(f"{tag} flash kernel vs einsum path end to end "
        f"({time.perf_counter() - t0:.1f} s; {docs:.4f} of the topics with "
        f"equal docids): first token agrees on {first:.4f} of {ne} topics "
        f"(G1's dense LM: >= {G1_FIRST_TOKEN_MIN}), all {cell.new} tokens on"
        f" {whole:.4f}; per-step agreement "
        f"{[round(float(x), 3) for x in same]}")

    # the witness: the same prefills walked each way of WALK, chunk by
    # chunk as the engine pads them, once the einsum path's graphs are gone
    t0 = time.perf_counter()
    Qe = {key: val[:ne] for key, val in Q.items()}
    pe = generate(f"{cfg.name}-einsum").assemble(
        Context(bx), Qe, {"docids": A["docids"][:ne]})
    e2e_first = Ax["tokens"][:, 0].long()
    del bx, Ax
    gc.collect()
    torch.cuda.empty_cache()
    firsts = {way: [] for way in WALK}
    diffs = dict.fromkeys(WALK, 0.0)
    alike = {way: [] for way in WALK}
    scale = 0.0
    for s0 in range(0, ne, C):
        n = min(C, ne - s0)
        pc = torch.cat([pe[s0:s0 + n], pe.new_zeros(C - n, P)])
        lg, shares = walk_routes(cfg, lm, pc, n)
        for way, x in lg.items():
            x = x[:n].float()
            firsts[way].append(x.argmax(-1))
            diffs[way] = max(diffs[way],
                             float((x - lg["einsum"][:n].float()).abs().max()))
            alike[way].append(shares[way])
        scale = max(scale, float(lg["einsum"].float().abs().max()))
        del lg, pc
    firsts = {way: torch.cat(x) for way, x in firsts.items()}
    agree = {way: float((x == firsts["einsum"]).float().mean())
             for way, x in firsts.items()}
    layers_alike = {way: [round(sum(c) / len(c), 4) for c in zip(*x)]
                    for way, x in alike.items()}
    log(f"{tag} the prefills walked layer by layer over {ne} topics "
        f"({time.perf_counter() - t0:.1f} s; the walk's einsum first tokens "
        f"vs the einsum Generate's "
        f"{float((firsts['einsum'] == e2e_first).float().mean()):.4f}): "
        f"first token as the einsum path's, "
        f"{ {w: round(agree[w], 4) for w in WALK if w != 'einsum'} }; "
        f"last-position logits max abs diff vs the einsum path "
        f"{ {w: round(diffs[w], 4) for w in WALK if w != 'einsum'} } "
        f"(largest {scale:.4g}); share of tokens routed as the einsum path,"
        f" per layer (mean over chunks): kernel {layers_alike['kernel']}, "
        f"plain {layers_alike['plain']}")
    assert torch.equal(firsts["kernel"].int(), tokens[:ne, 0]), \
        f"{cell.name}: the walk's kernel path is not the main path's"
    # the kernel agrees with the einsum path no less often than its plain
    # version does, routes free or pinned: within three standard errors
    # of a difference of two shares of ne topics
    for way in ("kernel", "kernel pinned"):
        p = agree[way.replace("kernel", "plain")]
        margin = 3 * math.sqrt(2 * max(p * (1 - p), 1 / ne) / ne)
        assert agree[way] >= p - margin, (cell.name, way, agree, margin)
    del lm, pe
    gc.collect()
    torch.cuda.empty_cache()
    return {"windows": windows}


# ---------------------------------------------------------------------------
# the training path: the flash Function, cell T1, StepGuard
# ---------------------------------------------------------------------------

#: the flash training path's checks: (name, B, S, H, Hkv, D, chunk).  Qwen2's
#: training shape (T1's micro-batch); Llama-4's heads at 4,096 tokens with
#: its chunk cut from 8,192 to 1,024 (a reduction), so that the fp32
#: reference's [S, T] scores fit and the chunked mask is exercised
FLASH_TRAIN_SHAPES = [("Qwen2 train", 2, 4096, 12, 2, 128, 0),
                      ("Llama-4 heads", 1, 4096, 40, 8, 128, 1024)]
#: relative Frobenius error of o and (dq, dk, dv) against autograd through
#: the plain version in fp32, by input dtype
FLASH_TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: cell T1 (its sequence is the arch's train_4k shape's): global batch,
#: micro-batches, warm-up steps, timed steps (one profiled step follows)
T1_BATCH, T1_MICRO, T1_WARM, T1_TIMED = 4, 2, 2, 8
#: T1's peak learning rate.  From the seed-0 draw (tied N(0, 1)
#: embeddings: logits of RMS ~39, ce 164.6) train_lm's default 3e-3 takes
#: ce to 425.2 by step 5 and AdamWConfig's default 3e-4 to 306.3 by step 4,
#: 169.8 at step 11; 1e-4 ends below the start (PERF.md, cell T1).  The
#: reference's own driver lifts ce above its start under 3e-3 at Qwen2's
#: d_model, and the port follows it (tests/test_torch_train_witness.py)
T1_LR = 1e-4
#: the StepGuard check on repro_torch.examples.train_lm's 100m preset
#: (d_head 64, a kernel shape): steps, checkpoint interval, the step that
#: fails
GUARD_STEPS, GUARD_EVERY, GUARD_FAIL = 8, 4, 7


def rel_fro(a, ref) -> float:
    import torch
    return float(torch.linalg.vector_norm(a.float() - ref) /
                 torch.linalg.vector_norm(ref))


def flash_train_bound(B, S, H, HKV, D, chunk) -> tuple[float, str]:
    """The least ms of the flash forward + backward in bf16: 4 x D flops
    a visible (query, key) pair and head forward, 10 backward (scores
    again, dP, dS to dQ and dK, P to dV), at 989 TFLOP/s; or q, k, v, o,
    dO read and dq, dk, dv written once at 3.35 TB/s."""
    ops = 14 * D * B * H * _visible_pairs(S, chunk)
    nbytes = 2 * B * S * D * 4 * (H + HKV)
    b_ops = 1e3 * ops / BF16_TC_OPS_PER_S
    b_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return max(b_ops, b_bytes), "operations" if b_ops >= b_bytes else "bytes"


def phase_flash_train(g, smi: str) -> dict:
    """``flash_attention_xla`` on the card, each shape of
    FLASH_TRAIN_SHAPES in fp32 and bf16: o and (dq, dk, dv) against
    autograd through ``flash_attention_ref`` in fp32 on the same values
    (bf16 inputs widened), relative Frobenius error within
    FLASH_TRAIN_TOL; one kernel launch a forward, none in the backward.
    At Qwen2's shape in bf16 it times the kernel's forward, the Function's
    forward + backward, the plain version's (the q-chunked forward and the
    same backward) and the library's (``scaled_dot_product_attention``,
    GQA, forward + backward).  Returns the timed row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    for name, B, S, H, HKV, D, chunk in FLASH_TRAIN_SHAPES:
        base = [torch.randn(B, S, h, D, device=DEVICE, generator=g)
                for h in (H, HKV, HKV, H)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (t.to(dtype) for t in base)
            leaves = [t.float().requires_grad_() for t in (q, k, v)]
            o_ref = flash_attention_ref(*leaves, causal=True, chunk=chunk)
            refs = [o_ref.detach(), *torch.autograd.grad(o_ref, leaves,
                                                         do.float())]
            del o_ref, leaves
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            before = ops.flash_attention.launches
            o = ops.flash_attention_xla(q, k, v, causal=True, chunk=chunk)
            fwd_launches = ops.flash_attention.launches - before
            got = [o.detach(), *torch.autograd.grad(o, (q, k, v), do)]
            assert ops.flash_attention.launches - before == fwd_launches == 1
            errs = [rel_fro(a, r) for a, r in zip(got, refs)]
            tol = FLASH_TRAIN_TOL[str(dtype).split(".")[1]]
            assert all(e <= tol for e in errs), (name, dtype, errs)
            assert all(a.dtype == dtype for a in got), (name, dtype)
            log(f"[flash train] {name}: q [{B}, {S}, {H}, {D}] k/v [{B}, "
                f"{S}, {HKV}, {D}] {dtype} causal chunk={chunk}: relative "
                f"Frobenius error vs autograd through the plain version in "
                f"fp32: o {errs[0]:.3e}, dq {errs[1]:.3e}, dk {errs[2]:.3e}"
                f", dv {errs[3]:.3e} (<= {tol}); 1 kernel launch, forward "
                f"only")
            del got, refs, o
        del base
        torch.cuda.empty_cache()
    name, B, S, H, HKV, D, chunk = FLASH_TRAIN_SHAPES[0]
    q, k, v, do = (torch.randn(B, S, h, D, device=DEVICE, generator=g)
                   .to(torch.bfloat16) for h in (H, HKV, HKV, H))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

    def function():
        o = ops.flash_attention_xla(qg, kg, vg, causal=True)
        return torch.autograd.grad(o, (qg, kg, vg), do)

    def plain():
        o = ops._flash_chunked_fwd(q, k, v, True, 0, ops.FLASH_BQ)
        return ops._flash_chunked_bwd(q, k, v, o, do, True, 0, ops.FLASH_BQ)

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def library():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (qt, kt, vt), dot)

    with torch.no_grad():
        fwd_ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    fb = (time_ms(function), time_ms(function))
    plain_ms = time_ms(plain, iters=3)
    lib_ms = time_ms(library)
    bound_ms, bound_by = flash_train_bound(B, S, H, HKV, D, 0)
    row = {"shape": f"q [{B}, {S}, {H}, {D}], k/v [{B}, {S}, {HKV}, {D}] "
                    f"bf16 causal, forward + backward",
           "forward_ms": fwd_ms, "ms": sum(fb) / 2, "readings": fb,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    log(f"[flash train] {name} bf16: kernel forward {fwd_ms:.4f} ms; the "
        f"Function's forward + backward {fb[0]:.4f} / {fb[1]:.4f} ms "
        f"(the backward plain torch in fp32); plain forward + backward "
        f"{plain_ms:.4f} ms; library (scaled_dot_product_attention, GQA) "
        f"forward + backward {lib_ms:.4f} ms; bound {bound_ms:.4f} ms "
        f"({bound_by}), {bound_ms / row['ms']:.4f} of the Function's; {smi}")
    del q, k, v, do, qg, kg, vg, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return row


def t1_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one T1 step: 6 x the matmul parameters (layers and
    unembedding) x tokens, plus causal attention 6 L B S^2 n_q d_head."""
    per_layer = cfg.d_model * cfg.d_head * 2 * (cfg.n_q + cfg.n_kv) + \
        3 * cfg.d_model * cfg.d_ff
    n = cfg.n_layers * per_layer + cfg.vocab * cfg.d_model
    return 6 * n * batch * seq + \
        6 * cfg.n_layers * batch * seq ** 2 * cfg.n_q * cfg.d_head


def phase_train_t1(smi: str, flash_row: dict) -> dict:
    """Cell T1: Qwen2-1.5B at full width trained through
    ``launch.train.train_lm`` (bf16, remat, ``attn_impl="flash"``, AdamW as
    train_lm sets it but for T1_LR, seed-0 weights, ``lm_batch_fn`` data):
    T1_WARM steps, T1_TIMED timed by CUDA events between step ends, one
    profiled.
    Holds ce falling, 2 x layers x micro-batches flash launches a step
    (forward and the remat recompute), step 1's ce within 1e-2 of the same
    weights and batch on the einsum path; prints step ms, tokens/s, the
    share of the bf16 FLOP bound, peak memory, the plain fp32 attention
    backward's share of the timed steps (CUDA events around it) and the
    profiled step's device time by operator.  Returns the launch window."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.train import train_lm
    from repro_torch.models import transformer_lm as tlm
    from repro_torch.train.data import lm_batch_fn
    arch = get_arch("qwen2-1.5b")
    cfg = dataclasses.replace(arch.model_cfg("train_4k"), attn_impl="flash")
    seq = arch.shapes["train_4k"]["seq"]
    steps = T1_WARM + T1_TIMED + 1
    per_step = 2 * cfg.n_layers * T1_MICRO
    # step 1 on the einsum path: the seed-0 draw train_lm makes, its
    # first batch, the mean of the micro-batches' ce
    lm = tlm.init_params(cfg, torch.Generator(DEVICE).manual_seed(0))
    first = lm_batch_fn(cfg.vocab, T1_BATCH, seq)(0)
    b = T1_BATCH // T1_MICRO
    xcfg = dataclasses.replace(cfg, attn_impl="xla")
    with torch.no_grad():
        xla_ce = sum(float(tlm.loss_fn(xcfg, lm, {
            key: torch.as_tensor(a[i * b:(i + 1) * b], device=DEVICE)
            for key, a in first.items()})[1]["ce"])
            for i in range(T1_MICRO)) / T1_MICRO
    del lm
    gc.collect()
    torch.cuda.empty_cache()

    ends, at_end, bwd, prof = [], [], [], {}
    real_bwd = ops._flash_chunked_bwd

    def timed_bwd(*args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_bwd(*args)
        ev[1].record()
        bwd.append(ev)
        return out

    def on_step(n, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        at_end.append(ops.flash_attention.launches)
        if n == T1_WARM:
            ops._flash_chunked_bwd = timed_bwd
        elif n == T1_WARM + T1_TIMED:
            ops._flash_chunked_bwd = real_bwd
            prof["p"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        elif n == steps:
            torch.cuda.synchronize()
            prof["wall"] = 1e3 * (time.perf_counter() - prof["t0"])
            prof["p"].__exit__(None, None, None)

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state, ce = train_lm(
            "qwen2-1.5b", reduced=False, steps=steps, batch=T1_BATCH,
            seq=seq, n_micro=T1_MICRO, attn_impl="flash", lr=T1_LR,
            ckpt_dir=str(Path(__file__).resolve().parent / "build" /
                         "t1_ckpt"),
            ckpt_every=steps + 1, log_every=steps + 1, on_step=on_step,
            device=DEVICE)
    finally:
        ops._flash_chunked_bwd = real_bwd
    window = read_launches("flash_attention")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    step_ms = ends[T1_WARM - 1].elapsed_time(ends[T1_WARM + T1_TIMED - 1]) \
        / T1_TIMED
    bwd_ms = sum(a.elapsed_time(z) for a, z in bwd) / T1_TIMED
    launches = [b - a for a, b in zip([0] + at_end, at_end)]
    flops = t1_flops(cfg, T1_BATCH, seq)
    bound_ms = 1e3 * flops / BF16_TC_OPS_PER_S
    tokens = T1_BATCH * seq
    assert all(math.isfinite(x) for x in ce), ce
    assert ce[-1] < ce[0] and sum(ce[-3:]) < sum(ce[:3]), ce
    assert launches == [per_step] * steps, launches
    assert window["flash_attention"]["device"] == \
        window["flash_attention"]["host"] == per_step * steps, window
    assert abs(ce[0] - xla_ce) <= 1e-2 * abs(xla_ce), (ce[0], xla_ce)
    assert len(bwd) == per_step // 2 * T1_TIMED, len(bwd)
    log(f"[T1] Qwen2-1.5B train ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_q}/{cfg.n_kv} heads of {cfg.d_head}, bf16, "
        f"remat, flash), batch {T1_BATCH} x {seq} tokens in {T1_MICRO} "
        f"micro-batches, AdamW (lr {T1_LR}, warm-up 1 step, cosine): step "
        f"{step_ms:.2f} ms (mean of {T1_TIMED} "
        f"after {T1_WARM} warm-up, CUDA events between step ends), "
        f"{tokens / step_ms * 1e3:.1f} tokens/s, {flops / step_ms / 1e9:.1f}"
        f" TFLOP/s of model FLOPs ({flops / 1e12:.2f} TFLOP a step), "
        f"{bound_ms / step_ms:.4f} of the bf16 bound ({bound_ms:.2f} ms at "
        f"989 TFLOP/s); peak device memory {peak} bytes; ce by step "
        f"{[round(x, 4) for x in ce]}; step 1 ce {ce[0]:.5f} vs "
        f"{xla_ce:.5f} on the einsum path (relative "
        f"{abs(ce[0] - xla_ce) / abs(xla_ce):.2e}); flash launches a step "
        f"{launches[0]} (device {window['flash_attention']['device']} in "
        f"{steps} steps); plain fp32 attention backward {bwd_ms:.2f} ms a "
        f"step, {bwd_ms / step_ms:.4f} of it ({len(bwd) // T1_TIMED} calls "
        f"a step); {wall:.1f} s in all; {smi}")
    log(f"[T1 profile] step {steps}: " +
        profile_text(prof["p"], prof["wall"], mark="flash"))
    row = {**flash_row, "launches": window["flash_attention"]["device"],
           "launches_a_step": per_step}
    log(f"[flash train row] {json.dumps(row)}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return window


def _state_bits(state) -> dict:
    """A host copy of every tensor of a train state, by dotted name."""
    from repro_torch.train.optimizer import named_leaves
    return {n: t.detach().to("cpu", copy=True)
            for n, t in named_leaves(state).items()}


def phase_stepguard(smi: str) -> None:
    """StepGuard on the card: repro_torch.examples.train_lm's 100m preset
    (bf16,
    flash, n_micro 2) for GUARD_STEPS steps with a checkpoint every
    GUARD_EVERY under build/, once as it is and once with a failure
    injected at step GUARD_FAIL; the guard restores the last checkpoint
    and replays.  Holds each step's ce bit-equal between the runs (the
    replayed steps too), and the state the replay starts from bit-equal
    to the state saved."""
    import functools
    import shutil
    import torch
    from repro_torch.models import transformer_lm as tlm
    from repro_torch.train import data as data_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    from repro_torch.examples.train_lm import PRESETS
    from repro_torch.train.fault import StepGuard
    p = PRESETS["100m"]
    cfg = tlm.LMConfig(name="lm-100m", tie_embeddings=True,
                       attn_impl="flash", **{k: v for k, v in p.items()
                                             if k not in ("batch", "seq")})
    opt_cfg = opt_lib.AdamWConfig(lr=3e-3, warmup_steps=1,
                                  total_steps=GUARD_STEPS)
    step_fn = ts.make_train_step(functools.partial(tlm.loss_fn, cfg),
                                 opt_cfg, n_micro=2)
    root = Path(__file__).resolve().parent / "build" / "stepguard"

    def run(fail_at: int | None):
        ckdir = root / ("failed" if fail_at else "clean")
        shutil.rmtree(ckdir, ignore_errors=True)
        state = ts.init_state(tlm.init_params(
            cfg, torch.Generator(DEVICE).manual_seed(0)))
        ce, seen = {}, {}
        calls = [0]

        def step(state, batch):
            calls[0] += 1
            if calls[0] == fail_at:
                raise RuntimeError("injected device loss")
            if fail_at and calls[0] == fail_at + 1:
                seen["restored"] = _state_bits(state)
            state, m = step_fn(state, batch)
            n = int(state["opt"]["step"])
            ce.setdefault(n, []).append(float(m["ce"]))
            if n == GUARD_EVERY * ((GUARD_FAIL - 1) // GUARD_EVERY):
                seen["saved"] = _state_bits(state)
            return state, m

        guard = StepGuard(ckdir, ckpt_every=GUARD_EVERY, max_retries=1)
        pipeline = data_lib.DataPipeline(
            data_lib.lm_batch_fn(cfg.vocab, p["batch"], p["seq"]))
        _, _, n = guard.run(state, pipeline.iter_from, step, GUARD_STEPS)
        assert n == GUARD_STEPS
        return ce, seen, guard.replays

    t0 = time.perf_counter()
    clean, _, replays = run(None)
    assert replays == 0 and all(len(v) == 1 for v in clean.values())
    failed, seen, replays = run(GUARD_FAIL)
    assert replays == 1
    assert set(failed) == set(clean) == set(range(1, GUARD_STEPS + 1))
    replayed = [n for n, v in failed.items() if len(v) > 1]
    for n, v in failed.items():
        assert all(x == clean[n][0] for x in v), (n, v, clean[n])
    saved, restored = seen["saved"], seen["restored"]
    assert saved.keys() == restored.keys()
    for name, t in saved.items():
        assert same_bits(t, restored[name]), name
    log(f"[stepguard] 100m preset ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_q}/{cfg.n_kv} heads of {cfg.d_head}, "
        f"vocab {cfg.vocab}, bf16, flash, n_micro 2), {GUARD_STEPS} steps, "
        f"a checkpoint every {GUARD_EVERY}, a failure injected at step "
        f"{GUARD_FAIL}: 1 replay from step "
        f"{GUARD_EVERY * ((GUARD_FAIL - 1) // GUARD_EVERY)}; ce by step "
        f"{[round(clean[n][0], 5) for n in sorted(clean)]} bit-equal in "
        f"both runs, the replayed steps {replayed} too; the restored state "
        f"({len(saved)} tensors) bit-equal to the saved one; "
        f"{time.perf_counter() - t0:.1f} s; {smi}")


# ---------------------------------------------------------------------------
# phase Z: the model zoo at its published widths
# ---------------------------------------------------------------------------

#: warm-up and timed steps of each zoo cell
Z_WARM, Z_TIMED = 2, 5
Z_RECSYS = ("dcn-v2", "autoint", "dien", "mind")
#: the serve_p99 rows held against the CPU at full width, and the bound:
#: the largest |difference| over the largest |CPU value|
Z_CPU_ROWS, Z_CPU_REL = 64, 1e-5
#: gat-cora's minibatch_lg base graph: Reddit's nodes, and its edges over
#: its nodes as random_graph's mean degree
Z_REDDIT_DEGREE = round(114_615_892 / 232_965)
#: the zoo cells that run one more step under torch.profiler
Z_PROFILED = {("dien", "train_batch"), ("gat-cora", "ogb_products")}
#: phase_zoo_reduced's second GAT comparison aggregates this many edges at
#: a time, far below the reduced graph's edge count
Z_GAT_CHUNK = 7


def leaf_bound(ref) -> float:
    """The zoo's card-vs-CPU bound: 1e-5 + 1e-4 x the leaf's largest
    |value|."""
    return 1e-5 + 1e-4 * float(ref.abs().max())


def zoo_module(arch_id: str):
    from repro_torch.configs.registry import get_arch
    return get_arch(arch_id).module


def dry_peak(arch_id: str, shape: str) -> int:
    """The one-card dry run's peak bytes of a cell (``launch/dryrun.py``:
    the bundle on ``meta``, priced by the op counter, on the host)."""
    from repro_torch.launch.dryrun import run_cell
    return run_cell(arch_id, shape, verbose=False)["bytes_per_device"]


def measured_peak(build, run):
    """(the card's peak bytes allocated while ``run(bundle)`` runs the
    steps of ``bundle = build()``, above what was allocated before the
    build, so the bundle's arguments count and the draw of its weights
    does not: the dry run prices the step on its arguments; the bundle)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    bundle = build()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run(bundle)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, bundle


def on_card(batch: dict) -> dict:
    import numpy as np
    import torch
    return {k: torch.from_numpy(np.asarray(v)).to(DEVICE)
            for k, v in batch.items()}


def step_ms(fn, warm: int = Z_WARM, timed: int = Z_TIMED) -> list[float]:
    """``fn()`` ``warm`` times, then ``timed`` times each between two CUDA
    events: the device milliseconds of each timed call (host stalls inside
    a call count, as a user would see them)."""
    import torch
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(timed)]
    for a, z in ev:
        a.record()
        fn()
        z.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(z) for a, z in ev]


def profile_text(prof, wall: float, mark: str | None = None) -> str:
    """A finished torch.profiler run that took ``wall`` host ms: device ms
    and idle share, the device ms of the kernels whose name holds ``mark``
    (when given), the operators' self device ms and the top kernels.
    Kernels are the device's events; an operator's self device time is
    that of the kernels it launched itself (a kernel launched through
    ctypes, as the flash kernel is, has no operator above it)."""
    import torch
    keys = prof.key_averages()

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    on_card = [e for e in keys if getattr(e, "device_type", None) ==
               torch.autograd.DeviceType.CUDA]
    ops_ = [e for e in keys if e not in on_card and dev_ms(e) > 0]
    total = sum(dev_ms(e) for e in on_card)
    text = (f"wall {wall:.1f} ms, device {total:.1f} ms (idle share "
            f"{1 - total / wall:.4f})")
    if mark:
        marked = sum(dev_ms(e) for e in on_card if mark in e.key)
        text += f", {mark} kernel {marked:.1f} ms"
    return (text + "; by operator (self device ms, calls): " +
            "; ".join(f"{e.key[:48]} {dev_ms(e):.1f} ({e.count})" for e in
                      sorted(ops_, key=dev_ms, reverse=True)[:12]) +
            "; top kernels: " + "; ".join(
                f"{e.key[:60]} {dev_ms(e):.1f} ({e.count})" for e in
                sorted(on_card, key=dev_ms, reverse=True)[:6]))


def profile_summary(fn) -> str:
    """``fn()`` once under torch.profiler, as :func:`profile_text` puts it
    (wall: the host's clock to a synchronise)."""
    import torch
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    return profile_text(prof, wall)


def zoo_card_vs_cpu(arch_id: str) -> str:
    """``arch_id``'s reduced config on the card against the same weights
    and batch on the CPU: loss, every gradient and the parameters after one
    AdamW step (lr 1e-3, 10 total steps), each within 1e-5 + 1e-4 x the
    CPU leaf's largest |value|.  Returns what it held, as text."""
    import functools
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    arch = get_arch(arch_id)
    cfg, batch_fn = arch.reduced()
    tm = arch.module
    cpu = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    models = {"cpu": cpu,
              "card": tm.from_arrays(cfg, tm.to_arrays(cpu), DEVICE)}
    got = {}
    for side, mod in models.items():
        dev = next(mod.parameters()).device
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in batch_fn().items()}
        state = ts.init_state(mod)
        loss, _ = tm.loss_fn(cfg, mod, batch)
        leaves = dict(mod.named_parameters())
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        step = ts.make_train_step(
            functools.partial(tm.loss_fn, cfg),
            opt_lib.AdamWConfig(lr=1e-3, total_steps=10))
        step(state, batch)
        got[side] = {"loss": loss.detach().cpu(),
                     **{f"grad {n}": g.cpu() for n, g in grads.items()},
                     **{f"step {n}": p.detach().cpu()
                        for n, p in leaves.items()}}
    worst = (0.0, "")
    for name, ref in got["cpu"].items():
        x = got["card"][name]
        assert bool(torch.isfinite(x).all()), (arch_id, name)
        err = float((x - ref).abs().max())
        assert err <= leaf_bound(ref), (arch_id, name, err)
        worst = max(worst, (err / leaf_bound(ref), name))
    return (f"{arch_id} ({cfg.name}): card vs CPU from the same weights and "
            f"batch, loss {float(got['card']['loss']):.6f} vs "
            f"{float(got['cpu']['loss']):.6f}; loss, {len(leaves)} gradients "
            f"and {len(leaves)} parameters after one AdamW step within "
            f"1e-5 + 1e-4 x the leaf's largest |value| (worst {worst[0]:.4f}"
            f" of its bound, {worst[1]})")


def phase_zoo_reduced() -> None:
    """Each zoo arch's reduced config on the card against the CPU
    (:func:`zoo_card_vs_cpu`); GAT a second time with its aggregation in
    chunks of Z_GAT_CHUNK edges, so that the chunk offsets and the
    hand-written backward are held across chunks on the card too."""
    from repro_torch.configs.registry import all_arch_ids, get_arch
    from repro_torch.models import gnn
    for arch_id in all_arch_ids():
        family = get_arch(arch_id).family
        if family == "lm":
            continue
        log(f"[Z reduced] {zoo_card_vs_cpu(arch_id)}")
        if family != "gnn":
            continue
        whole = gnn.MESSAGE_CHUNK
        gnn.MESSAGE_CHUNK = Z_GAT_CHUNK
        try:
            log(f"[Z reduced] aggregation in chunks of {Z_GAT_CHUNK} edges: "
                f"{zoo_card_vs_cpu(arch_id)}")
        finally:
            gnn.MESSAGE_CHUNK = whole


def zoo_recsys_cell(arch_id: str, shape: str, cell: dict) -> dict:
    """One recsys cell at the published widths, its step and arguments
    from ``launch.steps.build_bundle`` on the card (weights drawn from seed
    0, each field's ids below its vocabulary): ``train_batch`` as
    ``make_train_step`` steps (AdamW's defaults), ``serve_*`` as
    ``forward`` under ``no_grad`` (then a sigmoid, but for MIND),
    ``retrieval_cand`` as ``retrieval_score``.  Returns ms a step, rows/s,
    the peak memory beside the dry run's, the step's model FLOPs and share
    of the fp32 bound, the outputs of the last call and the weights."""
    import torch
    from repro_torch.launch.steps import build_bundle
    kind, rows = cell["kind"], cell["batch"]
    n = cell["candidates"] if kind == "retrieval" else rows
    out = {}

    def run_cell_steps(bundle):
        args = list(bundle.args)
        if kind == "train":
            losses = []

            def run():
                args[0], m = bundle.fn(*args)
                losses.append(next(iter(m.values())))
            out["ms"] = step_ms(run)
            if (arch_id, shape) in Z_PROFILED:
                out["profile"] = profile_summary(run)
            out["loss"] = torch.stack(losses).cpu()
        else:
            def run():
                out["y"] = bundle.fn(*args)
            out["ms"] = step_ms(run)
            assert out["y"].shape == (n,), (arch_id, shape, out["y"].shape)
    peak, bundle = measured_peak(
        lambda: build_bundle(arch_id, shape, device=DEVICE), run_cell_steps)
    for k in ("loss", "y"):
        if k in out:
            assert bool(torch.isfinite(out[k]).all()), (arch_id, shape, k)
    ms = out.pop("ms")
    mean = sum(ms) / len(ms)
    flops = bundle.model_flops_per_step
    bound = 1e3 * flops / FP32_OPS_PER_S
    params = bundle.args[0]["params"] if kind == "train" else bundle.args[0]
    return {"ms": mean, "all_ms": ms, "rows_per_s": n / mean * 1e3,
            "peak": peak, "dry_peak": dry_peak(arch_id, shape),
            "flops": flops, "bound_ms": bound, "share": bound / mean,
            "rows": n, "batch": bundle.args[1], "mod": params,
            "cfg": bundle_cfg(arch_id, shape), **out}


def bundle_cfg(arch_id: str, shape: str):
    from repro_torch.configs.registry import get_arch
    return get_arch(arch_id).model_cfg(shape)


def zoo_cpu_check(arch_id: str, cfg, mod, batch: dict, y) -> float:
    """``serve_p99``'s first Z_CPU_ROWS outputs against the CPU's from the
    same weights and rows: the largest |difference| over the largest |CPU
    value|, held to Z_CPU_REL."""
    import torch
    tm = zoo_module(arch_id)
    cpu = tm.from_arrays(cfg, tm.to_arrays(mod), device="cpu")
    rows = {k: v[:Z_CPU_ROWS].cpu() for k, v in batch.items()}
    with torch.no_grad():
        ref = tm.forward(cfg, cpu, rows)
        if arch_id != "mind":
            ref = torch.sigmoid(ref)
    rel = float((y[:Z_CPU_ROWS].cpu() - ref).abs().max() / ref.abs().max())
    assert rel <= Z_CPU_REL, (arch_id, rel)
    return rel


def phase_zoo_recsys(smi: str) -> None:
    """Cell Z1: DCN-v2, AutoInt, DIEN and MIND at ``model_cfg()`` (fp32,
    random weights from seed 0 on the card) at the four RECSYS_SHAPES
    cells, each a ``build_bundle`` step, with serve_p99 held against the
    CPU and each cell's peak memory beside its dry run's."""
    import torch
    from repro_torch.configs import shapes
    for arch_id in Z_RECSYS:
        for shape, cell in shapes.RECSYS_SHAPES.items():
            t0 = time.perf_counter()
            r = zoo_recsys_cell(arch_id, shape, cell)
            cfg = r["cfg"]
            if shape == "train_batch":
                params = sum(p.numel() for p in r["mod"].parameters())
                tables = {n: p.numel() * p.element_size()
                          for n, p in r["mod"].named_parameters()
                          if "table" in n}
                log(f"[Z1] {arch_id}: {cfg}; {params} parameters "
                    f"({4 * params} bytes fp32, AdamW's fp32 moments "
                    f"{8 * params} bytes); tables {tables} bytes")
            extra = ""
            if "loss" in r:
                extra = f"; loss by step {[round(float(x), 5) for x in r['loss']]}"
            if shape == "serve_p99":
                rel = zoo_cpu_check(arch_id, cfg, r["mod"], r["batch"],
                                    r["y"])
                extra = (f"; first {Z_CPU_ROWS} outputs vs the CPU's from "
                         f"the same weights: {rel:.3e} of the largest "
                         f"(bound {Z_CPU_REL})")
            what = "candidates" if cell["kind"] == "retrieval" else "rows"
            log(f"[Z1] {arch_id} {shape} ({r['rows']} {what}): "
                f"{r['ms']:.3f} ms a step (mean of {Z_TIMED} after "
                f"{Z_WARM} warm-up, CUDA events; each "
                f"{[round(x, 3) for x in r['all_ms']]}), "
                f"{r['rows_per_s']:.1f} {what}/s, peak device memory "
                f"{r['peak']} bytes (dry run {r['dry_peak']}, measured / "
                f"dry run {r['peak'] / r['dry_peak']:.4f}), model FLOPs "
                f"{r['flops'] / 1e9:.2f} G a step, {r['share']:.4f} of the "
                f"fp32 bound ({r['bound_ms']:.3f} ms at 67 TFLOP/s){extra}; "
                f"{time.perf_counter() - t0:.1f} s; {smi}")
            if "profile" in r:
                log(f"[Z1 profile] {arch_id} {shape}, one more step: "
                    f"{r['profile']}")
            del r
            gc.collect()
            torch.cuda.empty_cache()


def zoo_gat_batches(shape: str, cell: dict, cfg, seed: int):
    """gat-cora's host batches of a cell and the sampler's ms a batch
    (None but for minibatch_lg): one batch reused by every step, or for
    minibatch_lg one sampled batch a step."""
    import numpy as np
    from repro_torch.models import sampler
    rng = np.random.default_rng(seed)
    if shape == "minibatch_lg":
        t0 = time.perf_counter()
        g = sampler.random_graph(cell["base_nodes"], Z_REDDIT_DEGREE,
                                 cell["d_feat"], cell["n_classes"], seed=seed)
        built = time.perf_counter() - t0
        ns = sampler.NeighborSampler(g, list(cell["fanouts"]), seed=seed)
        batches, ms = [], []
        for _ in range(Z_WARM + Z_TIMED):
            t0 = time.perf_counter()
            seeds = ns.rng.integers(0, g.n_nodes, cell["batch_nodes"],
                                    dtype=np.int64)
            batches.append(ns.sample(seeds))
            ms.append(1e3 * (time.perf_counter() - t0))
        info = {"sampler_ms": ms, "graph_s": built,
                "base_edges": int(g.indptr[-1])}
        return batches, info
    if "n_graphs" in cell:
        return [sampler.pack_molecule_batch(
            rng, cell["n_graphs"], cell["nodes_per_graph"],
            cell["edges_per_graph"], cell["d_feat"], cell["n_classes"])], {}
    N, E = cell["n_nodes"], cell["n_edges"]
    return [{
        "x": rng.standard_normal((N, cell["d_feat"]), dtype=np.float32),
        "src": rng.integers(0, N, E, dtype=np.int32),
        "dst": rng.integers(0, N, E, dtype=np.int32),
        "labels": rng.integers(0, cell["n_classes"], N, dtype=np.int32),
        "label_mask": np.ones(N, bool),
    }], {}


def zoo_gat_cell(shape: str, cell: dict, seed: int) -> dict:
    """One gat-cora cell: the ``build_bundle`` train step (AdamW's
    defaults, the graph padded to 128 inside) at ``model_cfg(shape)``,
    random weights from seed 0 on the card, on the bundle's graph of the
    cell's size, or for minibatch_lg on one sampled batch a step."""
    import torch
    from repro_torch.launch.steps import build_bundle
    cfg = bundle_cfg("gat-cora", shape)
    batches, info = zoo_gat_batches(shape, cell, cfg, seed) \
        if shape == "minibatch_lg" else (None, {})
    res = {}

    def run_steps(b):
        state = b.args[0]
        losses, ms = [], []
        for i in range(Z_WARM + Z_TIMED):
            batch = b.args[1] if batches is None else on_card(batches[i])
            a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            state, m = b.fn(state, batch)
            z.record()
            losses.append(m["ce"])
            if i >= Z_WARM:
                ms.append((a, z))
            del batch
        torch.cuda.synchronize()
        res["ms"] = [a.elapsed_time(z) for a, z in ms]
        res["loss"] = torch.stack(losses).cpu()
        if ("gat-cora", shape) in Z_PROFILED:
            batch = b.args[1] if batches is None else on_card(batches[-1])

            def run():
                nonlocal state
                state, _ = b.fn(state, batch)
            res["profile"] = profile_summary(run)
            del batch
        res["state"] = state
    peak, b = measured_peak(
        lambda: build_bundle("gat-cora", shape, device=DEVICE), run_steps)
    info.update(loss=res["loss"])
    if "profile" in res:
        info["profile"] = res["profile"]
    assert bool(torch.isfinite(info["loss"]).all()), (shape, info["loss"])
    for p in res["state"]["params"].parameters():
        assert bool(torch.isfinite(p).all()), shape
    N = (cell["n_graphs"] * cell["nodes_per_graph"] if "n_graphs" in cell
         else cell["n_nodes"]) if batches is None else \
        batches[0]["x"].shape[0]
    E = (cell["n_graphs"] * cell["edges_per_graph"] if "n_graphs" in cell
         else cell["n_edges"]) if batches is None else \
        batches[0]["src"].shape[0]
    ms = res["ms"]
    mean = sum(ms) / len(ms)
    flops = b.model_flops_per_step
    bound = 1e3 * flops / FP32_OPS_PER_S
    return {"cfg": cfg, "N": N, "E": E, "ms": mean, "all_ms": ms,
            "peak": peak, "dry_peak": dry_peak("gat-cora", shape),
            "flops": flops, "bound_ms": bound, "share": bound / mean,
            **info}


def phase_zoo_gat(smi: str) -> None:
    """Cell Z2: gat-cora at the four GNN_SHAPES cells (fp32, seed 0)."""
    import numpy as np
    import torch
    from repro_torch.configs import shapes
    for j, (shape, cell) in enumerate(shapes.GNN_SHAPES.items()):
        t0 = time.perf_counter()
        r = zoo_gat_cell(shape, cell, seed=200 + j)
        extra = ""
        if "sampler_ms" in r:
            extra = (f"; base graph {cell['base_nodes']} nodes, "
                     f"{r['base_edges']} edges (random_graph, mean degree "
                     f"{Z_REDDIT_DEGREE}; {r['graph_s']:.1f} s on the "
                     f"host), sampler {np.mean(r['sampler_ms']):.1f} ms a "
                     f"batch on the host (each "
                     f"{[round(x, 1) for x in r['sampler_ms']]})")
        log(f"[Z2] gat-cora {shape}: {r['cfg']}; {r['N']} nodes, {r['E']} "
            f"edges: {r['ms']:.3f} ms a train step (mean of {Z_TIMED} after "
            f"{Z_WARM} warm-up, CUDA events; each "
            f"{[round(x, 3) for x in r['all_ms']]}), peak device memory "
            f"{r['peak']} bytes (dry run {r['dry_peak']}, measured / dry run "
            f"{r['peak'] / r['dry_peak']:.4f}), model FLOPs "
            f"{r['flops'] / 1e9:.2f} G a step (the bundle's graph), "
            f"{r['share']:.4f} of the fp32 bound ({r['bound_ms']:.3f} "
            f"ms at 67 TFLOP/s); ce by step "
            f"{[round(float(x), 5) for x in r['loss']]}{extra}; "
            f"{time.perf_counter() - t0:.1f} s; {smi}")
        if "profile" in r:
            log(f"[Z2 profile] gat-cora {shape}, one more step: "
                f"{r['profile']}")
        del r
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase X: the launch layer and the examples
# ---------------------------------------------------------------------------

#: the flash kernel at d_head 32: (name, B, S, H, Hkv), causal; the first
#: is repro_torch.examples.train_lm's 10m preset's batch
X_FLASH_SHAPES = [("10m preset", 8, 128, 8, 4), ("long rows", 4, 4096, 8, 4)]
#: train_lm's 10m preset on the card: steps
X_TRAIN_STEPS = 20
#: the full-width LM bundles of qwen2-1.5b run one step each, and their
#: overrides: decode_32k's cache is 120.3 GB in bf16 at 28 layers (its dry
#: run's peak 132.1 GB), so the card runs 14 of them
X_LM_BUNDLES = [("long_500k", None), ("decode_32k", {"n_layers": "14"})]
#: a measured peak within this share of its dry run's
X_PEAK_REL = 0.2
#: measures of an example on the card against its CPU run: rankings equal
#: but for score ties, which move a measure by a few thousandths
X_MEASURE_ATOL = 1e-3


def phase_flash_d32(smi: str) -> dict:
    """The flash kernels at d_head 32 against their plain version: fp32
    on the CUDA-core kernel (within 2e-6 of the plain version in float64),
    bf16 zero-padded to 64 for the wgmma kernel (within 2e-2 of the plain
    version), causal, at X_FLASH_SHAPES; timed beside the plain version and
    ``scaled_dot_product_attention`` (the bf16 kernel also alone on inputs
    padded ahead)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=DEVICE).manual_seed(32)
    rows = {}
    for name, B, S, H, HKV in X_FLASH_SHAPES:
        D = 32
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(B, S, h, D, device=DEVICE, generator=g)
                       .to(dt) for h in (H, HKV, HKV))
            a = flash_attention(q, k, v, causal=True)
            ref = flash_attention_ref(q, k, v, causal=True)
            torch.cuda.synchronize()
            assert a.shape == q.shape and a.dtype == dt
            diff = float((a.float() - ref.float()).abs().max())
            if dt == torch.float32:
                exact = flash_attention_ref(q.double(), k.double(),
                                            v.double(), causal=True)
                err = float((a.double() - exact).abs().max())
                assert err <= 2e-6 and diff <= 4e-6, (name, err, diff)
                del exact
            else:
                err = diff
                assert err <= 2e-2, (name, err)
            del a, ref
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            (ms_a, ms_b), plain, lib = time_in_turns(
                lambda: flash_attention(q, k, v, causal=True),
                lambda: flash_attention_ref(q, k, v, causal=True),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
            extra = ""
            if dt == torch.bfloat16:
                qp, kp, vp = (torch.nn.functional.pad(x, (0, 32))
                              for x in (q, k, v))
                alone = time_ms(lambda: flash_attention(qp, kp, vp,
                                                        causal=True))
                # the kernel at 64 on pre-padded inputs computes softmax
                # at the scale of 64; only its time is read here
                extra = (f"; the wgmma kernel alone on inputs padded "
                         f"ahead {alone:.4f} ms")
                del qp, kp, vp
            ms = (ms_a + ms_b) / 2
            ops = 4 * B * H * D * S * (S + 1) / 2
            nbytes = q.element_size() * (2 * q.numel() + k.numel() +
                                         v.numel())
            rate = BF16_TC_OPS_PER_S if dt == torch.bfloat16 \
                else FP32_OPS_PER_S
            b_ops = 1e3 * ops / rate
            b_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            bnd = max(b_ops, b_bytes)
            key = f"{name} {str(dt).removeprefix('torch.')}"
            rows[key] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                         "bound_ms": bnd, "max_abs_err": err,
                         "bound_by": "operations" if b_ops >= b_bytes
                         else "bytes"}
            log(f"[X flash d32] {key}: q {tuple(q.shape)} k/v "
                f"{tuple(k.shape)} causal, max abs err {err:.3e} (vs "
                f"{'float64' if dt == torch.float32 else 'the plain version'}"
                f"); kernel {ms_a:.4f} / {ms_b:.4f} ms (mean {ms:.4f}), plain "
                f"{plain:.4f} ms, library (scaled_dot_product_attention) "
                f"{lib:.4f} ms; bound {bnd:.4f} ms ({rows[key]['bound_by']}: "
                f"{ops / 1e9:.3f} GFLOP at "
                f"{'bf16 tensor-core' if dt == torch.bfloat16 else 'fp32'} "
                f"rate, {nbytes / 1e6:.2f} MB){extra}; {smi}")
            del q, k, v, qt, kt, vt
    return rows


def example_tables(res: dict) -> dict:
    """An Experiment result's rows: name -> {measure: value}."""
    return {r["name"]: {m: v for m, v in r.items()
                        if m in ("map", "ndcg_cut_10", "P_10")}
            for r in res["table"]}


def compare_tables(card: dict, cpu: dict, names) -> float:
    """The largest |difference| of the rows ``names``' measures, card vs
    CPU, held to X_MEASURE_ATOL."""
    worst = 0.0
    for n in names:
        for m, v in cpu[n].items():
            worst = max(worst, abs(card[n][m] - v))
    assert worst <= X_MEASURE_ATOL, (names, worst)
    return worst


#: the kernel each fused lowering launches
X_LOWERED = {"FusedTopKRetrieve": "topk", "FusedFatRetrieve": "fused_scoring",
             "FusedDenseRerank": "dense_topk",
             "FusedDenseRetrieve": "dense_topk"}


def example_routes(out: dict) -> tuple[dict, set]:
    """Each pipeline of an example's run compiled on its backend (the
    gate's decisions held), and the kernels those forms launch."""
    from repro_torch.core.ir import raise_ir
    forms = {n: repr(raise_ir(compile_checked(p, out["backend"])))
             for n, p in out["pipelines"].items()}
    return forms, {k for f in forms.values() for lowered, k in
                   X_LOWERED.items() if lowered + "(" in f}


def phase_examples(smi: str) -> list:
    """The four examples of ``repro_torch.examples`` at their own sizes on
    the card, their kernels counted from zero around each; each held to a
    CPU run where it is drawn alike (the Experiment rows, the served
    top-5).  Returns the launch windows."""
    import contextlib
    import io
    import shutil
    import torch
    from repro_torch.examples import (ltr_experiment, quickstart,
                                      serve_pipeline, train_lm)
    names = ("topk", "fused_scoring", "dense_topk", "pq_topk",
             "flash_attention")
    windows = []

    def on_both(mod):
        zero_launches()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            card = mod.run(DEVICE)
        counts = read_launches(*names)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cpu = mod.run("cpu")
        t_cpu = time.perf_counter() - t0
        windows.append(counts)
        return card, cpu, counts, out.getvalue(), t_card, t_cpu

    def routes(name, card, c):
        """The kernels the compiled forms launch ran, and no other."""
        forms, kernels = example_routes(card)
        for k in ("topk", "fused_scoring", "dense_topk", "pq_topk"):
            assert (c[k]["device"] > 0) == (k in kernels), (name, k, c,
                                                            forms)
        return (f"compiled forms {forms}: kernels on the route "
                f"{sorted(kernels) or 'none'}")

    card, cpu, c, text, tc, th = on_both(quickstart)
    worst = compare_tables(example_tables(card["result"]),
                           example_tables(cpu["result"]),
                           ("bm25", "fusion", "bm25+rm3"))
    assert card["traces"] == cpu["traces"]
    log(f"[X quickstart] {tc:.1f} s on the card ({th:.1f} s on the CPU); "
        f"rewrites {card['traces']}; launches {c}; "
        f"{routes('quickstart', card, c)}; Experiment rows within "
        f"{worst:.2e} of the CPU's\n{text.strip()}")

    card, cpu, c, text, tc, th = on_both(ltr_experiment)
    worst = compare_tables(example_tables(card["result"]),
                           example_tables(cpu["result"]),
                           ("bm25", "bm25+rm3", "sdm>>bm25"))
    log(f"[X ltr_experiment] {tc:.1f} s on the card ({th:.1f} s on the "
        f"CPU); launches {c}; {routes('ltr_experiment', card, c)}; first "
        f"three rows within {worst:.2e} of the CPU's (the LTR stage draws "
        f"its state from the card's generator)\n{text.strip()}")

    card, cpu, c, text, tc, th = on_both(serve_pipeline)
    worst = compare_tables(example_tables(card["result"]),
                           example_tables(cpu["result"]),
                           ("bm25@20", "bm25>>dense"))
    assert list(card["top5"]) == list(cpu["top5"]), (card["top5"],
                                                     cpu["top5"])
    assert card["stats"]["served"] == 24 and \
        card["rag_stats"]["decode"]["requests"] == 12
    assert card["rag_stats"]["recompiles_since_warmup"] == 0
    log(f"[X serve_pipeline] {tc:.1f} s on the card ({th:.1f} s on the "
        f"CPU); launches {c}; {routes('serve_pipeline', card, c)}; "
        f"Experiment rows within {worst:.2e} of the CPU's, served top-5 "
        f"{list(card['top5'])} equal\n{text.strip()}")

    ck = Path(__file__).resolve().parent / "build" / "x_lm_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ce = train_lm.run("10m", X_TRAIN_STEPS, ckpt_dir=str(ck),
                          device=DEVICE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = read_launches("flash_attention")
    windows.append(c)
    assert c["flash_attention"]["device"] > 0, c
    assert c["flash_attention"]["device"] == c["flash_attention"]["host"]
    assert all(math.isfinite(x) for x in ce) and ce[-1] < ce[0], ce
    log(f"[X train_lm] 10m preset (d_head 32, bf16, attn_impl flash, "
        f"n_micro 2), {X_TRAIN_STEPS} steps in {dt:.1f} s "
        f"({1e3 * dt / X_TRAIN_STEPS:.1f} ms a step with the first): ce "
        f"{[round(x, 4) for x in ce]}; flash launches {c['flash_attention']} "
        f"({c['flash_attention']['device'] / X_TRAIN_STEPS:.0f} a step); "
        f"{smi}\n{out.getvalue().strip()}")
    return windows


#: serve_demo's greedy tokens that the card's pool and the CPU's, from
#: the same bf16 weights and prompts, must share: their sums round in
#: other orders, and an argmax over bf16 logits flips where the top two
#: lie within a rounding
X_DEMO_SAME_MIN = 0.9


def phase_serve_demo() -> None:
    """``launch.serve.serve_demo`` on the card: every request served, and
    its tokens against the same demo on the CPU from the card's draw of
    the weights (carried over through ``init_params``), held to
    X_DEMO_SAME_MIN of the tokens."""
    import contextlib
    import io
    from repro_torch.launch import serve
    from repro_torch.models import transformer_lm as tlm
    drawn = {}
    real = tlm.init_params

    def spy(cfg, gen):
        drawn["lm"] = lm = real(cfg, gen)
        return lm

    tlm.init_params = spy
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            card = serve.serve_demo("qwen2-1.5b", device=DEVICE)
        cfg = serve.get_arch("qwen2-1.5b").reduced()[0]
        tlm.init_params = lambda c, gen: tlm.lm_from_arrays(
            c, tlm.lm_to_arrays(cfg, drawn["lm"]), gen.device)
        with contextlib.redirect_stdout(io.StringIO()):
            cpu = serve.serve_demo("qwen2-1.5b", device="cpu")
    finally:
        tlm.init_params = real
    assert len(card) == 8 and all(len(r.generated) == 12 for r in card)
    pairs = [(a, b) for r, h in zip(card, cpu)
             for a, b in zip(r.generated, h.generated)]
    same = sum(a == b for a, b in pairs) / len(pairs)
    assert same >= X_DEMO_SAME_MIN, (same, [r.generated for r in card],
                                     [r.generated for r in cpu])
    log(f"[X serve_demo] {out.getvalue().strip()}\n[X serve_demo] the CPU's "
        f"pool from the card's weights: {same:.4f} of the {len(pairs)} "
        f"tokens equal (first tokens "
        f"{sum(r.generated[0] == h.generated[0] for r, h in zip(card, cpu))}"
        f" of 8)")


def phase_lm_bundles(smi: str) -> None:
    """qwen2-1.5b's full-width serve bundles X_LM_BUNDLES built by
    ``build_bundle`` on the card (weights from seed 0, the cache zeros, the
    decode position the cache's last slot), one step each: finite logits,
    the peak memory within X_PEAK_REL of the same cell's dry run."""
    import torch
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.steps import build_bundle
    for shape, over in X_LM_BUNDLES:
        t0 = time.perf_counter()
        dry = run_cell("qwen2-1.5b", shape, overrides=over, verbose=False)
        out = {}

        def run(b):
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            logits, cache = b.fn(*b.args)
            z.record()
            torch.cuda.synchronize()
            out["ms"] = a.elapsed_time(z)
            out["finite"] = bool(torch.isfinite(logits).all())
            out["shape"] = tuple(logits.shape)
            out["cache"] = tuple(cache["k"].shape)
        # the bundle is dropped here: the next cell's needs the card
        peak = measured_peak(lambda: build_bundle(
            "qwen2-1.5b", shape, device=DEVICE, overrides=over), run)[0]
        ratio = peak / dry["bytes_per_device"]
        assert out["finite"], shape
        assert abs(ratio - 1) <= X_PEAK_REL, (shape, peak, dry)
        log(f"[X LM bundle] qwen2-1.5b x {shape} {over or ''}: cache "
            f"{out['cache']} bf16, one decode step {out['ms']:.2f} ms, "
            f"logits {out['shape']} finite; peak device memory {peak} "
            f"bytes, dry run {dry['bytes_per_device']} (memory "
            f"{dry['memory']}), measured / dry run {ratio:.4f}; "
            f"{time.perf_counter() - t0:.1f} s; {smi}")
        gc.collect()
        torch.cuda.empty_cache()


def phase_rq1(index, forms) -> tuple:
    import repro_torch as rt
    from repro_torch.core import BackendDescriptor
    caps = {"unoptimised": None,
            "kernels": BackendDescriptor.default({"fat", "fused_topk",
                                                  "fused_scoring"}),
            "full": BackendDescriptor.default()}
    want = {"kernels": "fused_topk_retrieve", "full": "pruned_retrieve"}
    bes = {name: rt.TorchBackend(index, default_k=1000, bucket_ladder=LADDER,
                                 descriptor=d, device=DEVICE)
           for name, d in caps.items()}
    pipe = rt.Retrieve("BM25") % 10
    for name, kind in want.items():
        got = compile_checked(pipe, bes[name]).kind
        assert got == kind, (name, got)
    runs = []
    for form, topics in forms.items():
        Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                            device=DEVICE)
        base = None
        for name, be in bes.items():
            res = rt.Experiment([pipe], Q, topics.qrels, ["map", "ndcg_cut_10"],
                                backend=be, optimize=name != "unoptimised",
                                measure_time=True)
            row, R = res["table"][0], res["results"][0]
            assert R["docids"].shape == (len(topics.qids), 10)
            assert bool(R["scores"].isfinite().all())
            base = R if base is None else base
            ovl = topk_overlap(base["docids"], R["docids"], 10)
            if name == "kernels":
                assert ovl >= 0.99, ovl
            runs.append((form, name, be, Q, topics, row, R))
            log(f"[rq1] {form:3s} {name:11s} map {row['map']:.4f} ndcg_cut_10 "
                f"{row['ndcg_cut_10']:.4f} mrt_ms {row['mrt_ms']:.4f} "
                f"topk_overlap {ovl:.4f}")
    return pipe, runs


def phase_rq1_sequential(pipe, runs) -> None:
    """RQ1's forms again under ``plan=False``, after the main path's counts
    are read: the planned default's mrt_ms (a sum of synchronised stages)
    beside the sequential path's (one synchronised run)."""
    import torch
    import repro_torch as rt
    for form, name, be, Q, topics, row, R in runs:
        seq = rt.Experiment([pipe], Q, topics.qrels, ["map"], backend=be,
                            optimize=name != "unoptimised",
                            measure_time=True, plan=False)
        assert torch.equal(seq["results"][0]["docids"], R["docids"])
        log(f"[rq1] {form:3s} {name:11s} mrt_ms plan=True {row['mrt_ms']:.4f}"
            f" plan=False {seq['table'][0]['mrt_ms']:.4f}")


def phase_rq2(index, forms) -> None:
    import torch
    import repro_torch as rt
    be = rt.TorchBackend(index, default_k=1000, bucket_ladder=LADDER,
                         device=DEVICE)
    pipe = (rt.Retrieve("BM25") >> (rt.Extract("QL") **
                                    rt.Extract("TF_IDF"))) % 1000
    got = compile_checked(pipe, be).kind
    assert got == "fused_fat_retrieve", got
    for form, topics in forms.items():
        Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                            device=DEVICE)
        out = {}
        for name, opt in (("unoptimised", False), ("optimised", True)):
            res = rt.Experiment([pipe], Q, topics.qrels, ["map"], backend=be,
                                optimize=opt, measure_time=True)
            out[name] = (res["table"][0], res["results"][0])
        (ru, Ru), (ro, Ro) = out["unoptimised"], out["optimised"]
        assert Ro["features"].shape == (len(topics.qids), 1000, 2)
        assert bool(Ro["features"].isfinite().all())
        same = Ru["docids"] == Ro["docids"]
        agree = float(same.float().mean())
        assert agree >= 0.99, agree
        diff = float((Ru["features"] - Ro["features"]).abs()[same].max())
        # both forms add the same per-term contributions in two different
        # orders (a slot loop against a sum over the query axis), over up
        # to 30 TDN terms
        torch.testing.assert_close(Ro["features"][same], Ru["features"][same],
                                   rtol=1e-4, atol=1e-4)
        log(f"[rq2] {form:3s} unoptimised mrt_ms {ru['mrt_ms']:.4f}  "
            f"optimised mrt_ms {ro['mrt_ms']:.4f}  map {ru['map']:.4f}/"
            f"{ro['map']:.4f}  docid agreement {agree:.5f}  feature_maxdiff "
            f"{diff:.3e}")


def _l1_pipelines(rt, ltr=None):
    """Cell L1's pipelines (Listing 1 at the paper's scale): four, and a
    fifth with ``ltr`` as its learning-to-rank stage when one is given."""
    bm25 = rt.Retrieve("BM25")
    pipes = {
        "bm25": bm25,
        "prf": bm25 >> rt.RM3Expand(fb_docs=10, fb_terms=10)
        >> rt.Retrieve("BM25"),
        "sdm": rt.SDMRewrite() >> rt.StemRewrite() >> rt.Retrieve("BM25"),
        "fusion": (0.7 * rt.Retrieve("BM25") + 0.3 * rt.Retrieve("QL"))
        % 1000}
    if ltr is not None:
        feats = rt.Extract("QL") ** rt.Extract("TF_IDF") ** rt.Extract("DPH")
        pipes["ltr"] = (rt.Retrieve("BM25") >> feats) % 1000 >> ltr
    return pipes


def _build_ltr(rt):
    feats = rt.Extract("QL") ** rt.Extract("TF_IDF") ** rt.Extract("DPH")
    return ((rt.Retrieve("BM25") >> feats) % 1000
            >> rt.LTRRerank(n_features=3, epochs=30))


def phase_l1(index, forms) -> dict:
    """Cell L1: Listing 1 on the card.  The 250 T topics split by
    ``kfold_splits(qids, 2, seed=0)`` into 125 training and 125 test
    topics; the LTR pipeline is fitted on the first, then a planned
    ``Experiment(measure_time=True)`` runs the five pipelines on the
    second.  Reads fused_scoring's launches right after it; then holds
    the first chunk's rankings against the host's run from the same state
    and FusedFatRetrieve's features against FatRetrieve's."""
    import copy
    import torch
    import repro_torch as rt
    from repro_torch.core import ir, tuning
    topics = forms["T"]
    Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                        device=DEVICE)
    train, test = next(tuning.kfold_splits(topics.qids, 2, seed=0))
    Qtr, Qte = tuning._subset(Q, train), tuning._subset(Q, test)
    qrels_tr = tuning._subset_qrels(topics.qrels, Qtr)
    qrels_te = tuning._subset_qrels(topics.qrels, Qte)
    be = rt.TorchBackend(index, default_k=1000, bucket_ladder=LADDER,
                         device=DEVICE)
    ltr = rt.LTRRerank(n_features=3, epochs=30)
    pipes = _l1_pipelines(rt, ltr)
    t0 = time.perf_counter()
    pipes["ltr"].fit(Qtr, qrels_tr, backend=be)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    log(f"[l1] LTRRerank fitted on {len(train)} training topics (30 epochs, "
        f"K 1000, the per-feature Extract path) in {fit_s:.2f} s; version "
        f"{ltr.version}")
    t0 = time.perf_counter()
    kinds = {name: compile_checked(p, be) for name, p in pipes.items()}
    compile_s = time.perf_counter() - t0
    log(f"[l1] cold compile of the five pipelines on a fresh backend "
        f"(gate estimates included) {compile_s:.3f} s")
    fusion, lt = kinds["fusion"], kinds["ltr"]
    assert fusion.kind == "cutoff" and \
        fusion.inputs[0].kind == "multi_retrieve", fusion.label()
    assert [o.kind for o in ir.chain(lt)] == ["fused_fat_retrieve", "ltr"]
    assert lt.inputs[1].ref is ltr          # the fitted stage itself

    zero_launches()
    res = rt.Experiment(list(pipes.values()), Qte, qrels_te,
                        ["map", "ndcg_cut_10"], backend=be,
                        names=list(pipes), measure_time=True)
    launches = read_launches("fused_scoring")
    plan = res["plan"]
    log(f"[l1] plan: {plan.n_stage_executions} stage executions for "
        f"{plan.n_stage_requests} requests; fused_scoring launches "
        f"{launches['fused_scoring']}")
    assert (plan.n_stage_executions, plan.n_stage_requests) == (9, 10)
    assert_eager_launches(launches, "L1")
    log(rt.format_table(res["table"]))
    for r in res["stage_table"]:
        log(f"[l1] stage {json.dumps(r)}")
    for row, R in zip(res["table"], res["results"]):
        assert all(math.isfinite(row[m]) for m in ("map", "ndcg_cut_10")), row
        assert R["docids"].shape == (len(test), 1000), row["name"]

    # the first chunk on the host, from the same index and fitted state
    host_ltr = rt.LTRRerank(n_features=3, epochs=30)
    host_ltr.state = copy.deepcopy(ltr.state).cpu()
    host = rt.TorchBackend(on_host(index), default_k=1000,
                           bucket_ladder=LADDER, device="cpu")
    Qh = {key: v[:CHUNK].cpu() for key, v in Qte.items()}
    n_ties = {}
    for (name, p), R in zip(_l1_pipelines(rt, host_ltr).items(),
                            res["results"]):
        Rh = rt.run_pipeline(p, Qh, backend=host)
        card = {key: v[:CHUNK].cpu() for key, v in R.items()}
        torch.testing.assert_close(card["scores"], Rh["scores"], rtol=2e-5,
                                   atol=1e-5)
        n_ties[name] = _check_docids(Rh["docids"], Rh["scores"],
                                     card["docids"])
    log(f"[l1] first chunk of {CHUNK} test topics: the card's rankings equal "
        f"the host's (plain versions, same fitted state) except inside score"
        f" ties, ranks by pipeline {n_ties}")
    fat = rt.FatRetrieve(model="BM25", features=("QL", "TF_IDF", "DPH"),
                         k=1000)
    Ru = rt.run_pipeline(fat, Qte, backend=be, optimize=False)
    Rf = rt.run_pipeline(lt.inputs[0], Qte, backend=be, optimize=False)
    same = Ru["docids"] == Rf["docids"]
    agree = float(same.float().mean())
    assert agree >= 0.99, agree
    torch.testing.assert_close(Rf["features"][same], Ru["features"][same],
                               rtol=1e-4, atol=1e-4)
    diff = float((Rf["features"] - Ru["features"]).abs()[same].max())
    log(f"[l1] FusedFatRetrieve vs FatRetrieve on the test topics: docid "
        f"agreement {agree:.5f}, feature_maxdiff {diff:.3e}")
    return {"be": be, "Q": Q, "Qtr": Qtr, "Qte": Qte, "qrels_tr": qrels_tr,
            "qrels_te": qrels_te, "fit_s": fit_s, "launches": launches}


def phase_tuning(forms, l1) -> None:
    """Cross-validation of the LTR pipeline (5 folds over the 250 T topics)
    and a grid search of RM3's feedback depths on the 125 training topics,
    whose shared Context must run the first-pass Retrieve once."""
    import torch
    import repro_torch as rt
    from repro_torch.core.transformer import Generic
    be, topics = l1["be"], forms["T"]
    t0 = time.perf_counter()
    cv = rt.CrossValidate(lambda: _build_ltr(rt), l1["Q"], topics.qrels,
                          k=5, metrics=("map", "ndcg_cut_10"), backend=be)
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    for m in ("map", "ndcg_cut_10"):
        assert all(math.isfinite(f[m]) for f in cv["folds"]), cv
    log(f"[cv] 5 folds of the LTR pipeline over 250 T topics in {cv_s:.2f} s:"
        f" folds {json.dumps(cv['folds'])}; mean {json.dumps(cv['mean'])}")

    # a counting probe after the first pass: the grid's shared Context
    # runs it once (6 times without the memo)
    calls = {"n": 0}

    def counting(Q, R):
        calls["n"] += 1
        return Q, R

    first = rt.Retrieve("BM25") >> Generic(fn=counting)
    t0 = time.perf_counter()
    grid = rt.GridSearch(
        lambda fb_terms, fb_docs: first >> rt.RM3Expand(
            fb_docs=fb_docs, fb_terms=fb_terms) >> rt.Retrieve("BM25"),
        {"fb_terms": [5, 10, 20], "fb_docs": [5, 10]}, l1["Qtr"],
        l1["qrels_tr"], metric="map", backend=be)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    n_cand = len(grid["table"])
    assert calls["n"] == 1, calls
    log(f"[grid] {n_cand} RM3 candidates on {len(l1['Qtr']['qid'])} training"
        f" topics in {grid_s:.2f} s; the first pass ran once for all of "
        f"them; best {grid['best_params']} map {grid['best_score']:.4f}; "
        f"table {json.dumps(grid['table'])}")


def phase_planner(forms, l1) -> None:
    """Cell P1 (the planner's amortisation, ``bench_planner``'s form): three
    pipelines sharing ``Retrieve("BM25", k=1000)``, planned against
    sequential with a fresh memo each, warmed, best of 3; then the artifact
    cache over L1's first three pipelines, twice."""
    import tempfile
    import torch
    import repro_torch as rt
    from repro_torch.core import Context
    from repro_torch.core.plan import backend_digest
    be, topics = l1["be"], forms["T"]
    Q = l1["Q"]
    nq = len(topics.qids)
    pipes = [rt.Retrieve("BM25", k=1000) >> rt.Extract(m)
             for m in ("QL", "TF_IDF", "DPH")]
    t0 = time.perf_counter()
    plan = rt.ExperimentPlan(pipes, be, optimize=False)
    plan_s = time.perf_counter() - t0
    plan.execute(Q, ctx=Context(be))                # warm-up
    t_plan = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan.execute(Q, ctx=Context(be))
        torch.cuda.synchronize()
        t_plan.append(time.perf_counter() - t0)
    # sequential: a warmed, synchronised run a pipeline, each with a fresh
    # memo (no sharing); its mrt_ms summed over the three
    seq_ms = []
    for _ in range(3):
        res = rt.Experiment(pipes, Q, topics.qrels, ["map"], backend=be,
                            optimize=False, plan=False, share_cache=False,
                            measure_time=True)
        seq_ms.append(sum(r["mrt_ms"] for r in res["table"]))
    assert (plan.n_stage_executions, plan.n_stage_requests) == (4, 6)
    plan_ms = 1e3 * min(t_plan) / nq
    log(f"[p1] {plan.n_stage_executions} stage executions for "
        f"{plan.n_stage_requests} requests; planned mrt_ms {plan_ms:.4f}, "
        f"sequential mrt_ms {min(seq_ms):.4f}, ratio "
        f"{min(seq_ms) / plan_ms:.3f} (best of 3, 250 T topics, chunks of "
        f"{CHUNK})")

    fresh = rt.TorchBackend(be.index, default_k=1000, bucket_ladder=LADDER,
                            device=DEVICE)
    t0 = time.perf_counter()
    dig = backend_digest(fresh)
    dig_s = time.perf_counter() - t0
    three = list(_l1_pipelines(rt).values())[:3]
    t0 = time.perf_counter()
    rt.ExperimentPlan(three, fresh)
    three_s = time.perf_counter() - t0
    log(f"[p1] cold compile: P1's plan {plan_s:.3f} s (optimize=False), L1's "
        f"first three pipelines planned on a fresh backend {three_s:.3f} s")
    with tempfile.TemporaryDirectory() as d:
        runs = []
        for _ in range(2):
            cache = rt.ArtifactCache(d)
            t0 = time.perf_counter()
            res = rt.Experiment(three, l1["Qte"], l1["qrels_te"], ["map"],
                                backend=fresh, artifact_cache=cache)
            runs.append((cache.hits, cache.misses,
                         time.perf_counter() - t0, res["results"]))
    (h1, m1, s1, r1), (h2, m2, s2, r2) = runs
    assert h1 == 0 and h2 > 0, (h1, h2)
    for a, b in zip(r1, r2):
        assert torch.equal(a["docids"], b["docids"])
        assert same_bits(a["scores"], b["scores"])
    log(f"[cache] backend_digest {dig[:12]} in {dig_s:.2f} s (the index read "
        f"from the card once); first run {h1} hits / {m1} misses in "
        f"{s1:.2f} s, second {h2} hits / {m2} misses in {s2:.2f} s; "
        f"rankings equal bit for bit")


#: cell A1, the measured optimiser (``bench_autotune`` of
#: benchmarks/ir_bench.py at Robust04 scale): the sparse workloads' gate
#: capabilities and band (every gate measured), and the profile's file
A1_CAPS = frozenset({"fat", "multi_model", "fused_topk", "fused_scoring"})
A1_BAND = 10.0
A1_PROFILE = Path(__file__).resolve().parent / "build" / "tuning_profile.json"
#: shard counts of the doc-sharded D2 check
DOC_SHARDS = (1, 2, 4, 8)


def _calibration_record(d: dict) -> dict | None:
    """``fit_peaks``-shaped record of one measured gate decision (each
    candidate's op counts and probe seconds)."""
    keys = ("fused_measured_s", "unfused_measured_s", "fused_flops",
            "unfused_flops", "fused_bytes", "unfused_bytes")
    if not all(d.get(k) for k in keys):
        return None
    return {side: {"flops": d[f"{side}_flops"], "bytes": d[f"{side}_bytes"],
                   "measured_s": d[f"{side}_measured_s"]}
            for side in ("unfused", "fused")}


def _ratio(a, b):
    return None if not (a and b) else round(a / b, 4)


def phase_autotune(index, forms, state, smi: str) -> dict:
    """Cell A1: the paper's backend-aware optimiser on the card.  A cold
    tune (the profile file deleted first) of three sparse workloads under
    capabilities A1_CAPS and band A1_BAND, so that every sparse gate is
    measured by CUDA events, and of D3 and D4 under the full capabilities
    and the default band, whose IVF knobs (nprobe; the PQ kernel's tile)
    are measured; then a warm compile of the same on fresh backends and a
    fresh read of the profile, which must replay every decision with no
    estimate and no probe.  Prints each decision's predicted and measured
    fused/unfused ratio and each knob's candidates; fits the roofline peaks
    from the measured decisions and shows a third descriptor that attaches
    the profile: refitted, or on the datasheet peaks where ``fit_refusal``
    refuses the fit.  Holds every PQ tile candidate bit-equal, times the
    tiles on the kernel alone, and runs D3 and D4 on the 250 T topics with the
    tuned knobs beside the untuned ones (MRT, recall@10 against D2).
    Counts launches from zero over the phase; the main path's windows are
    read before it."""
    import torch
    import repro_torch as rt
    from repro_torch.analysis.op_cost import (PEAK_BYTES_PER_S,
                                              PEAK_FLOPS_PER_S, fit_peaks,
                                              fit_refusal)
    from repro_torch.core import TuningProfile
    from repro_torch.core.plan import backend_digest
    from repro_torch.index import dense as DN
    from repro_torch.index.robust04 import NPROBE, PQ_M, PQ_REFINE
    from repro_torch.kernels.pq_scoring.ops import plan as plan_pq
    zero_launches()
    t_phase = time.perf_counter()
    A1_PROFILE.parent.mkdir(parents=True, exist_ok=True)
    A1_PROFILE.unlink(missing_ok=True)          # a cold tune
    sparse = {
        "retrieve_topk": rt.Retrieve("BM25") % 10,
        "fat_scorer_topk": (rt.Retrieve("BM25")
                            >> (rt.Extract("QL") ** rt.Extract("TF_IDF")))
        % 10,
        "mixed_k_linear": 0.5 * rt.Retrieve("BM25", k=200)
        + 0.5 * rt.Retrieve("QL", k=1000)}
    dense = {"D3": rt.DenseRetrieve(k=10, nprobe=NPROBE) % 10,
             "D4": rt.DenseRetrieve(k=10, nprobe=NPROBE, pq=True) % 10}

    def backends(prof):
        """(sparse, dense) backends over the main path's state, sharing
        one profile object, so that neither save drops the other's
        entries."""
        kw = dict(default_k=1000, bucket_ladder=LADDER, device=DEVICE)
        sd = (rt.BackendDescriptor.default(A1_CAPS, device=DEVICE)
              .with_profile(prof).with_autotune(True, band=A1_BAND))
        dd = (rt.BackendDescriptor.default(device=DEVICE)
              .with_profile(prof).with_autotune(True))
        return (rt.TorchBackend(index, descriptor=sd, **kw),
                rt.TorchBackend(index, state["dense"], ivf=state["ivf"],
                                ivfpq=state["ivfpq"], pq_m=PQ_M,
                                pq_refine=PQ_REFINE, descriptor=dd, **kw))

    phases = {}
    for phase in ("cold", "warm"):
        prof = TuningProfile(A1_PROFILE)
        be_s, be_d = backends(prof)
        # the profile's key digests each backend's content (the index read
        # from the card once a backend): timed apart from the compiles
        t0 = time.perf_counter()
        backend_digest(be_s), backend_digest(be_d)
        digest_s = time.perf_counter() - t0
        out = {}
        for name, pipe in {**sparse, **dense}.items():
            rep = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op = rt.compile_pipeline(pipe, be_d if name in dense else be_s,
                                     report=rep)
            out[name] = {"s": time.perf_counter() - t0, "op": op,
                         "tuning": rep["tuning"],
                         "decisions": rep["fusion_decisions"]}
        phases[phase] = (out, prof, be_s, be_d)
        tot = {k: sum(w["tuning"][k] for w in out.values())
               for k in next(iter(out.values()))["tuning"]}
        log(f"[a1] {phase} compile {sum(w['s'] for w in out.values()):.3f} "
            f"s ({', '.join(f'{n} {w['s']:.3f}' for n, w in out.items())}) "
            f"after the backends' digests {digest_s:.2f} s; tuning {tot}; "
            f"profile {prof.info()}")
    cold, _, be_s, be_d = phases["cold"]
    warm, prof_w, _, _ = phases["warm"]
    n_cold = 0
    records = []
    clock = "CUDA events" if DEVICE != "cpu" else "host clock"
    for name, w in cold.items():
        for d in w["decisions"]:
            n_cold += 1
            assert d["source"] not in ("estimate_failed", "probe_failed"), d
            if d.get("knob"):
                log(f"[a1] {name} knob {d['knob']}: chosen {d['chosen']} "
                    f"(configured {d['configured']}); seconds "
                    f"{d['measured_knob_s']}; overlap@10 against the widest "
                    f"{d['overlap_at_k']}")
                continue
            if name in sparse:
                assert d["source"] == "measured", (name, d)
            rec = _calibration_record(d)
            if rec:
                records.append(rec)
            log(f"[a1] {name} gate [{d['pattern']}] "
                f"{'fused' if d['accepted'] else 'kept unfused'} "
                f"({d['source']}): predicted fused/unfused "
                f"{_ratio(d['fused_proxy_s'], d['unfused_proxy_s'])}, "
                f"measured {_ratio(d['fused_measured_s'], d['unfused_measured_s'])}"
                f" (fused {d['fused_measured_s']}, unfused "
                f"{d['unfused_measured_s']} s, {clock})")
        log(f"[a1] {name} lowers to {w['op'].label()}")
    for name, w in warm.items():
        assert w["op"].key() == cold[name]["op"].key(), name
        assert all(d["source"] == "profile" for d in w["decisions"]), name
    wt = {k: sum(w["tuning"][k] for w in warm.values())
          for k in ("gate_estimates", "probe_measurements", "profile_hits",
                    "profile_misses")}
    assert wt["gate_estimates"] == 0 and wt["probe_measurements"] == 0, wt
    assert wt["profile_hits"] == n_cold and wt["profile_misses"] == 0, \
        (wt, n_cold)
    log(f"[a1] warm compile replays all {n_cold} cold decisions: {wt}")

    fit = fit_peaks(records)
    assert fit is not None, records
    log(f"[a1] fit_peaks over {fit['n_records']} measured decisions: "
        f"{json.dumps(fit)} on {smi} (datasheet: 6.7e13 flop/s, 3.35e12 "
        f"B/s)")
    prof_w.note_calibration(fit)
    prof_w.save()
    third = rt.BackendDescriptor.default(device=DEVICE).with_profile(
        TuningProfile(A1_PROFILE))
    refusal = fit_refusal(fit)
    peaks = (third.peak_flops_per_s, third.peak_bytes_per_s)
    if refusal is None:
        assert peaks == (fit["peak_flops_per_s"], fit["peak_bytes_per_s"])
        log(f"[a1] a third descriptor attaching the profile refits its "
            f"peaks to {peaks[0]:.4e} flop/s, {peaks[1]:.4e} B/s (digest "
            f"{third.peak_digest})")
    else:
        assert peaks == (PEAK_FLOPS_PER_S, PEAK_BYTES_PER_S), peaks
        log(f"[a1] the fit is neither noted nor applied ({refusal}): a "
            f"third descriptor attaching the profile keeps the datasheet "
            f"peaks {peaks[0]:.4e} flop/s, {peaks[1]:.4e} B/s")

    # every tile the PQ knob measured gives the default tile's result
    topics = forms["T"]
    Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                        device=DEVICE)
    qv = be_d.embed_queries(Q)
    knobs = [d for d in cold["D4"]["decisions"]
             if d.get("knob") == "pq_block"]
    # the tile is a knob of the card's kernel (a CPU rehearsal has none)
    assert len(knobs) == (DEVICE != "cpu"), knobs
    blocks = knobs[0]["candidates"] if knobs else []
    d4 = cold["D4"]["op"].params
    npb, sl = d4["nprobe"], d4["pq_shortlist"]
    base = DN.ivfpq_retrieve_topk_fused(state["ivfpq"], qv, k=10, nprobe=npb,
                                        refine=PQ_REFINE, shortlist=sl)
    for blk in blocks:
        got = DN.ivfpq_retrieve_topk_fused(state["ivfpq"], qv, k=10,
                                           nprobe=npb, refine=PQ_REFINE,
                                           shortlist=sl, block=blk)
        assert torch.equal(got[0], base[0]) and same_bits(got[1], base[1]), \
            blk
    log(f"[a1] pq_block candidates {blocks} give the default "
        f"tile's docids and scores bit for bit on the {len(topics.qids)} T "
        f"topics (nprobe {npb}, shortlist {sl})")
    if blocks:
        # the tiles on the kernel alone, at the main path's shape (the
        # first chunk of T topics at D4's configured nprobe), in turns
        from repro_torch.kernels.pq_scoring.ops import streaming_pq_topk
        codes, table, pbase, _, r = DN._pq_candidates(
            state["ivfpq"], qv[:LADDER[0]], k=10, nprobe=NPROBE,
            refine=PQ_REFINE, shortlist=None)
        tiles = sorted({plan_pq(codes.shape[1], codes.shape[2],
                                table.shape[2], b)[2]
                        for b in (64, 128, 216, 432, 864, 1728, 3456)})
        ms = {b: [] for b in tiles}
        for turn in (tiles, tiles[::-1]):
            for b in turn:
                ms[b].append(time_ms(lambda: streaming_pq_topk(
                    codes, table, pbase, k=r, block=b)))
        log(f"[a1] pq_topk alone on codes {list(codes.shape)}, k={r}, per "
            f"tile (rows: ms in two turns): "
            f"{ {b: [round(x, 4) for x in v] for b, v in ms.items()} } on "
            f"{smi}")

    d2 = rt.Experiment([rt.DenseRetrieve(k=10, nprobe=0) % 10], Q,
                       topics.qrels, ["map"], backend=state["be"])
    d2 = d2["results"][0]["docids"]
    out = {}
    for name, pipe in dense.items():
        row = {}
        for label, be in (("untuned", state["be"] if name == "D3"
                           else state["be_pq"]), ("tuned", be_d)):
            r = rt.Experiment([pipe], Q, topics.qrels, ["map"], backend=be,
                              measure_time=True)
            row[label] = (r["table"][0]["mrt_ms"],
                          topk_overlap(r["results"][0]["docids"], d2, 10))
        assert row["tuned"][1] >= row["untuned"][1] - be_d.descriptor \
            .autotune_band, (name, row)
        out[name] = row
        log(f"[a1] {name} on {len(topics.qids)} T topics, tuned "
            f"({cold[name]['op'].label()})"
            f" mrt_ms {row['tuned'][0]:.4f} recall@10 vs D2 "
            f"{row['tuned'][1]:.4f}; untuned mrt_ms {row['untuned'][0]:.4f} "
            f"recall@10 {row['untuned'][1]:.4f}")
    launches = read_launches("topk", "fused_scoring", "dense_topk", "pq_topk")
    for name, c in launches.items():
        assert c["device"] > 0, (name, c)
    log(f"[a1] launches in the phase (probes, knob search, D3/D4 runs) "
        f"{launches}; phase {time.perf_counter() - t_phase:.1f} s")
    return {"fit": fit, "dense": out}


def phase_doc_sharded(forms, state) -> None:
    """D2's ``[528155, 64]`` store cut into DOC_SHARDS contiguous shards,
    each searched by a ``dense_retrieve_exact_fused`` program on the
    dense-scoring kernel and merged by ``run_doc_sharded``: docids and
    scores bit-equal to the unsharded D2 search over the 250 T topics."""
    import torch
    import repro_torch as rt
    from repro_torch.core import StageProgram
    from repro_torch.core.engine import ShardedQueryEngine
    from repro_torch.index import dense as DN
    topics = forms["T"]
    Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                        device=DEVICE)
    qv = state["be"].embed_queries(Q)
    eng = ShardedQueryEngine(DEVICE, ladder=LADDER)
    k = 10
    dense = state["dense"]
    ref = eng.run(StageProgram(key=("d2", k), fn=lambda q: DN
                               .dense_retrieve_exact_fused(dense, q, k=k)),
                  None, qv)
    ref_d, ref_v = ref[0].cpu().numpy(), ref[1].cpu().numpy()
    ms = {}
    for n in DOC_SHARDS:
        shards = DN.shard_dense_index(dense, n)
        progs = [StageProgram(
            key=("d2 shard", n, off),
            fn=lambda q, sh=sh, off=off: (lambda dv: (dv[0] + off, dv[1]))(
                DN.dense_retrieve_exact_fused(sh, q,
                                              k=min(k, sh.emb.shape[0]))))
            for sh, off in shards]
        eng.run_doc_sharded(progs, None, qv, k=k)         # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        docs, vals = eng.run_doc_sharded(progs, None, qv, k=k)
        ms[n] = 1e3 * (time.perf_counter() - t0) / len(topics.qids)
        assert (docs == ref_d).all(), n
        assert (vals.view("uint32") == ref_v.view("uint32")).all(), n
    log(f"[doc-shard] D2 [{dense.emb.shape[0]}, {dense.dim}] cut into "
        f"{DOC_SHARDS} contiguous shards, each on the dense-scoring kernel, "
        f"merged by run_doc_sharded: docids and scores bit-equal to the "
        f"unsharded search on the {len(topics.qids)} T topics; ms/query by "
        f"shard count "
        f"(host clock, barrier and host merge included) {ms}")


def _tenant_latency(reqs) -> dict:
    """Served requests a second, and p50 / p95 latency (ms), of one
    tenant's requests, from their traces: served over the span from the
    first arrival to the last completion."""
    import numpy as np
    served = [r for r in reqs if r.result is not None]
    lat = np.array([r.trace.latency_ms for r in served])
    span = max(r.trace.t_done for r in reqs) - \
        min(r.trace.t_arrival for r in reqs)
    return {"requests": len(reqs), "served": len(served),
            "served_per_s": round(len(served) / span, 1),
            "p50_ms": round(float(np.percentile(lat, 50)), 3),
            "p95_ms": round(float(np.percentile(lat, 95)), 3)}


def _results(reqs, key):
    import numpy as np
    return np.concatenate([r.result[key] for r in reqs])


def _check_pinned_donation() -> None:
    """A pinned program's captured graph adopts the buffer of its donated
    argument: replays update the caller's buffer in place, and a call that
    donates another buffer raises instead of copying it over the first."""
    import torch
    from repro_torch.core import StageProgram
    from repro_torch.core.engine import ShardedQueryEngine
    eng = ShardedQueryEngine(DEVICE)
    prog = StageProgram(key=("donation check",),
                        fn=lambda x, buf: buf.add_(x))
    a, b = (torch.zeros(1024, device=DEVICE) for _ in range(2))
    one = torch.ones(1024, device=DEVICE)
    for _ in range(3):
        a = eng.run_pinned(prog, one, a, donate_argnums=(1,))
    assert bool((a == 3).all()), a[:4]
    try:
        eng.run_pinned(prog, one, b, donate_argnums=(1,))
    except ValueError:
        pass
    else:
        raise AssertionError("a foreign donated buffer was copied in")
    assert bool((b == 0).all()) and bool((a == 3).all())
    log("[serve] a pinned graph owns its donated buffer: 3 replays added 3 "
        "in place, another buffer raised and was left untouched")


def phase_serve(index, forms, state, g1) -> dict:
    """Cell S1, the served path: one ``MultiPipelineServer`` over the
    Robust04-scale index with the engine's default ladder, four tenants —
    ``ql`` and ``tfidf`` (``Retrieve("BM25", k=100) >> Extract(...)``,
    unoptimised, so they share the Retrieve prefix in the stage cache),
    ``top10`` (``Retrieve("BM25") % 10`` on the top-k kernel) and ``rag``
    (G1's pipeline on G1's LM, decoded in a pool of 8 slots whose prefill
    and step are captured graphs).  Traffic: warm-up on one T topic, the
    250 T topics to ql then to tfidf as standing bursts, 32 T topics to
    rag, and once they decode 64 TD topics each to ql and top10 with
    serve_bench's 250 ms deadline.  Holds the served results to
    ``run_pipeline``'s and G1's, asserts zero captures after warm-up and
    the kernels' launches on the served path, then holds each kernel
    against its plain version at the served shapes."""
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.core import BackendDescriptor, ir
    from repro_torch.core.descriptor import DEFAULT_CAPABILITIES
    from repro_torch.kernels.dense_scoring.ops import streaming_dense_topk
    from repro_torch.kernels.dense_scoring.ref import dense_topk_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.topk.ops import streaming_topk
    from repro_torch.kernels.topk.ref import streaming_topk_ref
    from repro_torch.serve import DeadlineUnmeetable
    cfg, lm = g1["cfg"], g1["lm"]
    # exact top-k without block-max pruning, so that "% 10" lowers onto
    # the top-k kernel
    desc = BackendDescriptor.default(DEFAULT_CAPABILITIES - {"pruned_topk"})
    be = rt.TorchBackend(index, state["dense"], default_k=1000,
                         descriptor=desc, device=DEVICE)
    be.register_lm(cfg.name, cfg, lm)
    gen = rt.Generate(cfg.name, max_new_tokens=G1_NEW,
                      max_prompt_len=G1_PROMPT, prompt_docs=G1_DOCS)
    shared = {"ql": rt.Retrieve("BM25", k=100) >> rt.Extract("QL"),
              "tfidf": rt.Retrieve("BM25", k=100) >> rt.Extract("TF_IDF")}
    optimised = {"top10": rt.Retrieve("BM25") % 10,
                 "rag": rt.Retrieve("BM25") >> rt.DenseRerank() % G1_DEPTH
                 >> gen}
    server = rt.MultiPipelineServer(
        shared, be, rt.ServeConfig.default(optimize=False, max_queue=4096)
        .with_decode(S1_SLOTS))
    for name, pipe in optimised.items():
        server.add_pipeline(pipe, name=name, optimize=True)
    chains = {name: [op.kind for op in ir.chain(compile_checked(
        pipe, be, optimize=name in optimised))]
        for name, pipe in {**shared, **optimised}.items()}
    assert chains["top10"] == ["fused_topk_retrieve"], chains
    assert chains["rag"] == ["fused_dense_rerank", "generate"], chains
    T, TD = (rt.make_queries(f.terms, f.weights, f.qids, device=DEVICE)
             for f in (forms["T"], forms["TD"]))
    nq = int(T["qid"].shape[0])

    def rows(Q, a, b):
        return {key: val[a:b] for key, val in Q.items()}

    _check_pinned_donation()
    t0 = time.perf_counter()
    warm = server.warmup(rows(T, 0, 1))
    torch.cuda.synchronize()
    warm_causes = be.engine.compiles_by_cause()
    log(f"[serve] warm-up {time.perf_counter() - t0:.1f} s: tenants "
        f"{chains}, ladder {be.engine.ladder}; program-cache entries by "
        f"cause {warm_causes} (pinned: the decode pool's prefill and step, "
        f"each a captured CUDA graph); warm-up report {warm}")

    # the served main path: counts from zero, read right after it
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t_main = time.perf_counter()
    reqs, split = {}, {}
    for name in shared:
        t0 = time.perf_counter()
        reqs[name] = server.submit(T, pipeline=name)
        t1 = time.perf_counter()
        server.pump()
        split[name] = (round(1e3 * (t1 - t0), 3),
                       round(1e3 * (time.perf_counter() - t1), 3))
    pool = server._pools["rag"]
    step_s, inner = [], pool._step

    def timed_step(*args):
        t0 = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    pool._step = timed_step
    reqs["rag"] = server.submit(rows(T, 0, S1_RAG), pipeline="rag")
    while server.stats()["decode_pools"]["rag"]["active"] == 0:
        server.step(drain=True)
    slo = {"ql SLO": [], "top10 SLO": []}
    at_door = dict.fromkeys(slo, 0)
    for i in range(S1_SLO):
        for name in slo:
            try:
                slo[name].append(server.submit_one(
                    rows(TD, i, i + 1), pipeline=name.split()[0],
                    timeout_ms=S1_SLO_MS))
            except DeadlineUnmeetable:
                at_door[name] += 1
    server.pump()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = read_launches("topk", "dense_topk", "flash_attention")
    peak = torch.cuda.max_memory_allocated()
    pool._step = inner
    stats = server.stats()
    reqs.update(slo)
    lat = {name: _tenant_latency(r) for name, r in reqs.items()}
    log(f"[main] S1 {main_s:.1f} s: {json.dumps(lat)}; SLO requests shed "
        f"at the door {at_door}; launches on the served path (device: "
        f"runs on the card, replays of the pool's graphs included; host: "
        f"counted by the wrappers) {launches}; peak device memory {peak} "
        f"bytes")
    for name, c in launches.items():
        assert c["device"] > 0, f"kernel {name} did not run on the served path"
    # every request ended served, or dropped at its deadline (shed at the
    # door or at batch close, or expired in the queue): none in error, and
    # none without a deadline dropped
    for name, rs in reqs.items():
        errors = [r.error for r in rs if r.error is not None]
        assert not errors, (name, errors[:3])
        lost = [r for r in rs if r.result is None and not r.trace.timed_out]
        assert not lost, (name, [r.rid for r in lost])
        if name in slo:
            n_drop = sum(r.trace.timed_out for r in rs)
            assert lat[name]["served"] + n_drop + at_door[name] == \
                S1_SLO, (name, lat[name], n_drop, at_door[name])
        else:
            assert lat[name]["served"] == len(rs), (name, lat[name])
    drops = {name: {"shed at close": sum(r.trace.shed for r in slo[name]),
                    "expired in queue": sum(r.trace.timed_out
                                            and not r.trace.shed
                                            for r in slo[name])}
             for name in slo}
    log(f"[serve] SLO bursts of {S1_SLO} requests a tenant: shed at the "
        f"door {at_door}, deadline drops after admission {drops}; no request"
        f" in error, every one served or dropped at its deadline")
    hits = stats["pipelines"]["tfidf"]["cross_pipeline_prefix_hits"]
    recompiles = stats["recompiles_since_warmup"]
    steps = np.array(step_s) * 1e3
    n_tok = sum(len(r.result["tokens"][0]) for r in reqs["rag"])
    log(f"[serve] tfidf cross_pipeline_prefix_hits {hits} of {nq}; "
        f"recompiles_since_warmup {recompiles}; program-cache entries by "
        f"cause {be.engine.compiles_by_cause()}; decode pool of "
        f"{S1_SLOTS} slots: {len(steps)} steps, {steps.mean():.3f} ms/step "
        f"mean, {np.median(steps):.3f} median, {steps.min():.3f} min "
        f"(host clock around each replay and its token read-back; G1 "
        f"offline decode ms/step above), {n_tok} tokens for {S1_RAG} "
        f"requests = {1e3 * n_tok / steps.sum():.0f} tokens/s of decode "
        f"time; engine {stats['engine']['service_ms_ewma']} ms per bucket;"
        f" bursts (submit ms, pump ms) {split}; {stats['batches']} batches "
        f"of {stats['mean_batch_size']} requests on average")
    assert hits == nq, hits
    assert recompiles == 0, recompiles

    # served results against the offline ones
    for name, pipe in shared.items():
        want = rt.run_pipeline(pipe, T, backend=be, optimize=False)
        for key in ("docids", "scores", "features"):
            got = torch.as_tensor(_results(reqs[name], key))
            assert same_bits(got, want[key].cpu()), (name, key)
    pos = {q: j for j, q in enumerate(TD["qid"].tolist())}
    for name, pipe, opt in (("ql SLO", shared["ql"], False),
                            ("top10 SLO", optimised["top10"], True)):
        served = [r for r in slo[name] if r.result is not None]
        sel = torch.tensor([pos[r.qid] for r in served])
        want = rt.run_pipeline(pipe, TD, backend=be, optimize=opt)
        for key in ("docids", "scores"):
            got = torch.as_tensor(_results(served, key))
            assert same_bits(got, want[key].cpu()[sel]), (name, key)
    got_d = torch.as_tensor(_results(reqs["rag"], "docids"))
    got_t = torch.as_tensor(_results(reqs["rag"], "tokens"))
    want_t = g1["tokens"][:S1_RAG].cpu()
    assert torch.equal(got_d, g1["docids"][:S1_RAG].cpu())
    first = float((got_t[:, 0] == want_t[:, 0]).float().mean())
    whole = float((got_t == want_t).all(1).float().mean())
    log(f"[serve] served rankings and features equal run_pipeline's bit for "
        f"bit (ql, tfidf, ql SLO, top10 SLO); rag docids equal G1's; rag "
        f"tokens (ragged decode in the pool) vs G1's (batch decode): first "
        f"token agrees on {first:.4f} of {S1_RAG}, all {G1_NEW} on "
        f"{whole:.4f}")
    assert first >= G1_FIRST_TOKEN_MIN, first

    # each kernel against its plain version at the served shapes: a full
    # bucket of BM25 rows for the top-k, the rag tenant's gathered
    # candidates for dense_topk, one slot's prefill for flash attention
    g = torch.Generator(device=DEVICE).manual_seed(2)
    scores = torch.rand(be.engine.ladder[-1], index.n_docs, device=DEVICE,
                        generator=g)
    v1, i1 = streaming_topk(scores, k=10)
    v2, i2 = streaming_topk_ref(scores, k=10)
    assert same_bits(v1, v2) and torch.equal(i1.long(), i2.long())
    emb = state["dense"].emb
    docs = torch.randint(0, index.n_docs, (be.engine.ladder[-1], 1000),
                         device=DEVICE, generator=g)
    qv = torch.randn(be.engine.ladder[-1], emb.shape[1], device=DEVICE,
                     generator=g)
    base = torch.zeros(docs.shape, device=DEVICE)
    v1, i1 = streaming_dense_topk(emb[docs], qv, base, k=G1_DEPTH)
    v2, i2 = dense_topk_ref(emb[docs], qv, base, k=G1_DEPTH)
    torch.testing.assert_close(v1, v2, rtol=1e-5, atol=1e-5)
    n_ties = _check_docids(i2, v2, i1, rtol=1e-5, atol=1e-5)
    q = torch.randn(1, G1_PROMPT, cfg.n_q, cfg.d_head, device=DEVICE,
                    generator=g).to(torch.bfloat16)
    k, v = (torch.randn(1, G1_PROMPT, cfg.n_kv, cfg.d_head, device=DEVICE,
                        generator=g).to(torch.bfloat16) for _ in range(2))
    diff = float((flash_attention(q, k, v, causal=True).float()
                  - flash_attention_ref(q, k, v, causal=True).float())
                 .abs().max())
    assert diff <= 2e-2, diff
    log(f"[serve] kernels at the served shapes: topk [{scores.shape[0]}, "
        f"{index.n_docs}] k=10 bit-equal to its plain version; dense_topk "
        f"{tuple(emb[docs].shape)} k={G1_DEPTH} within 1e-5 ({n_ties} "
        f"rank(s) inside a tie); flash_attention q {tuple(q.shape)} bf16 "
        f"within {diff:.4f} of its plain version (2e-2)")
    return launches


# ---------------------------------------------------------------------------
# phase M: the LM serve steps on a mesh of cards
# ---------------------------------------------------------------------------

#: the mesh of phase M with 4 cards or more, (data, model)
M_SHAPE = (2, 2)
#: check 1, sharded against one card: the LMs at full width and 2 layers
#: in bf16, each with its overrides (internlm2 on the flash kernel, as M2
#: runs it); batch, prompt and cache cut so that the one-card run fits
#: rank 0's card.  The MoE LM's routes are pinned to the one-card run's
#: (``expert_idx``): in bf16 the all-reduces' order moves a router score
#: across a near-tie often enough to change a last position's logits on
#: random weights, so its unpinned run only reports the share of equal
#: picks
M_CHECK_ARCHS = (("qwen2-1.5b", None), ("internlm2-1.8b",
                                         {"attn_impl": "pallas"}),
                 ("olmoe-1b-7b", None))
M_CHECK_LAYERS = 2
M_CHECK_BATCH, M_CHECK_PROMPT, M_CHECK_CACHE = 8, 512, 1024
#: the mesh's logits within this relative norm of the one-card logits
#: (||mesh - one card|| / ||one card||: each side rounds to bf16 after
#: sums in its own order, a few ulps of 2^-8 over two layers; a sharded
#: layer that drops half its heads or half its FFN moves the logits by a
#: tenth or more), and the share of rows whose argmax agrees at least
#: this (two of the 8 rows may flip where their top two lie within the
#: error; a wrong sharded layer scrambles most)
M_CHECK_REL, M_CHECK_ARGMAX_MIN = 2.0 ** -5, 0.75
#: check 2: the full cells at full depth on the 2x2 mesh: (name, arch,
#: shape, overrides)
M_CELLS = [("M1", "qwen2-1.5b", "decode_32k", None),
           ("M2", "internlm2-1.8b", "prefill_32k", {"attn_impl": "pallas"}),
           ("M3", "olmoe-1b-7b", "long_500k", None)]
M_TIMED = 3
#: a rank's measured peak within this factor of its dry run's
M_PEAK_REL = 0.05
#: seconds a rank may take
M_TIMEOUT = 900
#: check 3, the sharded train step against one card: the LMs at full
#: width and M_CHECK_LAYERS layers in fp32 on the flash training path
#: (qwen2 fsdp, internlm2 tp, olmoe tp + EP), one AdamW step of one
#: batch of M_TRAIN_BATCH x M_TRAIN_SEQ tokens at learning rate M_TRAIN_LR
M_TRAIN_ARCHS = ("qwen2-1.5b", "internlm2-1.8b", "olmoe-1b-7b")
M_TRAIN_BATCH, M_TRAIN_SEQ, M_TRAIN_LR = 8, 512, 1e-3
#: its limits: ce, moe_aux, moe_z and grad_norm within this relative of
#: the one-card step's; each gradient, gathered, within this relative
#: norm of one card's; each parameter after the step by the floor rule of
#: tests/test_torch_train_lm.py::test_train_step_matches_reference
M_TRAIN_RTOL, M_TRAIN_GRAD_REL = 1e-5, 1e-4
#: cell M4: qwen2-1.5b x train_4k at full width and depth on the 2x2 mesh
#: (bf16, remat, the flash training path, the cell's batch of 256 x
#: 4,096), its micro-batches the first of M4_MICRO whose dry-run peak a
#: card holds: one warm-up step and one timed step
M4 = ("M4", "qwen2-1.5b", "train_4k", {"attn_impl": "flash"})
M4_MICRO = (16, 32, 64)


def _mesh_gather(logits, mesh, spec):
    """The whole logits from the rank's shard [B_l, V_l] of ``spec``."""
    from repro_torch import collectives as C
    from repro_torch import sharding as sh
    logits = C.all_gather(logits, mesh, sh.spec_axes(spec, 1), 1)
    return C.all_gather(logits, mesh, sh.spec_axes(spec, 0), 0)


def mesh_check(mesh, arch_id: str, over) -> dict:
    """Check 1 on one rank: a prefill and one decode step of ``arch_id``
    (with ``over``) at full width and M_CHECK_LAYERS layers in bf16, on
    rank 0's card alone and then on ``mesh`` (the seed-0 draw cut to the
    rank's shards), gathered; rank 0 compares the logits.  An MoE LM runs
    on the mesh twice: with its own routing (the share of expert picks
    equal to the one-card run's is reported) and with every layer's
    routes pinned to the one-card run's, whose logits and drops are
    compared."""
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as sh
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer_lm as tlm
    cfg = dataclasses.replace(get_arch(arch_id).model_cfg(),
                              n_layers=M_CHECK_LAYERS, dtype=torch.bfloat16,
                              **(over or {}))
    dev = mesh.device
    B, P, T = M_CHECK_BATCH, M_CHECK_PROMPT, M_CHECK_CACHE
    toks = torch.randint(0, cfg.vocab, (B, P + 1), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    rank0 = mesh.coords == {a: 0 for a in mesh.axis_names}
    want, one_routes = [], []
    if rank0:
        with torch.no_grad():
            one = tlm.init_params(cfg, torch.Generator(dev).manual_seed(0))
            cache = tlm.init_kv_cache(cfg, B, T, device=dev)
            want.append(tlm.prefill(cfg, one, toks[:, :P], cache,
                                    metrics=one_routes)[0])
            want.append(tlm.decode_step(cfg, one, toks[:, P:], cache, P,
                                        metrics=one_routes)[0])
        del one, cache
        gc.collect()
        torch.cuda.empty_cache()
    pins = None
    if cfg.moe:
        # every layer's routes of the prefill, then of the decode step
        k = cfg.moe.top_k
        pins = [torch.empty(n, k, dtype=torch.int64, device=dev)
                for n in [B * P] * M_CHECK_LAYERS + [B] * M_CHECK_LAYERS]
        for i, t in enumerate(pins):
            if rank0:
                t.copy_(one_routes[i]["expert_idx"])
            dist.broadcast(t, 0)
    specs = tlm.serve_specs(cfg, mesh, B, P, T)
    rows = sh.local_slices(specs["tokens"], (B, P), mesh, mesh.coords)[0]
    n = M_CHECK_LAYERS

    def on_mesh(lm, pinned):
        routes: list = []
        cache = tlm.init_kv_cache(cfg, B, T, mesh=mesh)
        lg, _ = tlm.prefill(cfg, lm, toks[rows, :P], cache, mesh=mesh,
                            metrics=routes,
                            expert_idx=pins[:n] if pinned else None)
        got = [_mesh_gather(lg, mesh, specs["logits"])]
        lg, _ = tlm.decode_step(cfg, lm, toks[rows, P:], cache, P, mesh=mesh,
                                metrics=routes,
                                expert_idx=pins[n:] if pinned else None)
        got.append(_mesh_gather(lg, mesh, specs["logits"]))
        return got, routes

    out = {"arch": arch_id, "dtype": "bfloat16", "overrides": over or {},
           "shards": {k: list(s) for k, s in (
               ("tokens", specs["tokens"]), ("cache", specs["cache"]),
               ("logits", specs["logits"]))}}
    with torch.no_grad():
        lm = tlm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                             mesh=mesh)
        if cfg.moe:
            _, routes = on_mesh(lm, False)
            same = sum(int((m["expert_idx"] == p).sum())
                       for m, p in zip(routes, pins))
            out["route_agree"] = same / sum(p.numel() for p in pins)
        got, routes = on_mesh(lm, cfg.moe is not None)
    del lm
    if rank0:
        if cfg.moe:
            out["dropped"] = [int(m["dropped"]) for m in routes]
            out["dropped_one_card"] = [int(m["dropped"])
                                       for m in one_routes]
        for step, g, w in zip(("prefill", "decode"), got, want):
            g, w = g.float(), w.float()
            out[step] = {
                "rel": float(torch.linalg.vector_norm(g - w)
                             / torch.linalg.vector_norm(w)),
                "max_abs_err": float((g - w).abs().max()),
                "rms": float(w.square().mean().sqrt()),
                "max_abs": float(w.abs().max()),
                "argmax_agree": float((g.argmax(-1) == w.argmax(-1))
                                      .float().mean()),
                "finite": bool(torch.isfinite(g).all())}
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _flash_shapes(fn, entry: str = "flash_attention"):
    """(``fn()``, the set of (q shape, k shape, dtype, causal, chunk) that
    the LM layers handed the flash kernel's ``entry`` during it: its
    inference entry, or ``"flash_attention_xla"``, the training one)."""
    from repro_torch.models import layers
    seen, inner = set(), getattr(layers, entry)

    def spy(q, k, v, *, causal=True, chunk=0, **kw):
        seen.add((tuple(q.shape), tuple(k.shape), str(q.dtype), causal,
                  chunk))
        return inner(q, k, v, causal=causal, chunk=chunk, **kw)

    setattr(layers, entry, spy)
    try:
        return fn(), seen
    finally:
        setattr(layers, entry, inner)


#: the (batch, kv head) groups of a rank's flash call held against the
#: plain version, as fractions of (B - 1, Hkv - 1): first, middle, last
M_FLASH_GROUPS = ((0, 0), (0.5, 0.5), (1, 1))


def mesh_flash_check(shapes, seed: int) -> list[dict]:
    """The flash kernel at each of a rank's ``shapes`` (from
    :func:`_flash_shapes`) on N(0, 1) bf16 inputs: held against the plain
    version's fp32 result on M_FLASH_GROUPS (``attention_errors``; 2e-2
    absolute, REL_TOL, ROW_REL_TOL), and timed beside its bound, its plain
    version on one (batch, kv head) group and, where no chunk masks it,
    ``scaled_dot_product_attention`` (causal, GQA)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    out = []
    for qs, ks, dtype, causal, chunk in sorted(shapes):
        B, S, H, D = qs
        HKV = ks[2]
        G = H // HKV
        q, k, v = (torch.randn(*s, device=DEVICE, generator=g)
                   .to(getattr(torch, dtype.removeprefix("torch.")))
                   for s in (qs, ks, ks))
        a = flash_attention(q, k, v, causal=causal, chunk=chunk)
        diff = rel = row = 0.0
        groups = sorted({(round(fb * (B - 1)), round(fj * (HKV - 1)))
                         for fb, fj in M_FLASH_GROUPS})
        for b, j in groups:
            h = slice(G * j, G * j + G)
            ref = flash_attention_ref(
                q[b:b + 1, :, h].float(), k[b:b + 1, :, j:j + 1].float(),
                v[b:b + 1, :, j:j + 1].float(), causal=causal, chunk=chunk)
            e = attention_errors(a[b:b + 1, :, h], ref)
            diff, rel, row = max(diff, e[0]), max(rel, e[1]), max(row, e[2])
            del ref
            torch.cuda.empty_cache()
        ms = time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                             chunk=chunk), iters=3)
        # the plain version on the first group alone (whole, its fp32
        # scores of the larger shapes would not fit the card)
        b, j = groups[0]
        one = [t[b:b + 1, :, sl].float() for t, sl in
               ((q, slice(G * j, G * j + G)), (k, slice(j, j + 1)),
                (v, slice(j, j + 1)))]
        plain = time_ms(lambda: flash_attention_ref(
            *one, causal=causal, chunk=chunk), iters=3)
        del one
        library = None
        if not chunk:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True), iters=3)
            del qt, kt, vt
        ops = 4 * B * H * D * _visible_pairs(S, chunk) if causal else \
            4 * B * H * D * S * ks[1]
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        bound = max(1e3 * ops / BF16_TC_OPS_PER_S, 1e3 * nbytes /
                    HBM_BYTES_PER_S)
        out.append({"q": list(qs), "k": list(ks), "dtype": dtype,
                    "causal": causal, "chunk": chunk, "groups": groups,
                    "max_abs_err": diff, "rel": rel, "row": row,
                    "ok": diff <= 2e-2 and rel <= REL_TOL and row <= 1.0,
                    "ms": ms, "bound_ms": bound, "library_ms": library,
                    "plain_ms_one_group": plain})
        del q, k, v, a
        torch.cuda.empty_cache()
    return out


def mesh_cell(mesh, name: str, arch_id: str, shape: str, over) -> dict:
    """Check 2 on one rank: the cell's bundle on ``mesh`` (full width and
    depth), its dry run at the rank's coordinates first, and the flash
    kernel at the shapes that dry run hands it (:func:`mesh_flash_check`),
    before the bundle is built; one warm-up step
    (its collectives recorded) and M_TIMED steps between CUDA events; the
    rank's peak memory above what it held before the build, and the flash
    kernel's launches over the four steps; then one step profiled on rank
    0 (:func:`profile_summary`)."""
    import torch
    import torch.distributed as dist
    from repro_torch import collectives, kernels
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.steps import build_bundle
    t0 = time.perf_counter()
    shape_only = mesh_lib.Mesh(tuple(mesh.shape.values()), mesh.axis_names,
                               coords=mesh.coords)
    dry, shapes = _flash_shapes(lambda: run_cell(
        arch_id, shape, mesh=shape_only, overrides=over, verbose=False))
    dry_s = time.perf_counter() - t0
    # the flash kernel at the rank's own shapes of this cell, against its
    # plain version, before the bundle takes the card
    flash_check = mesh_flash_check(shapes, 7 + dist.get_rank())
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    b = build_bundle(arch_id, shape, mesh=mesh, overrides=over)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    own = torch.cuda.current_device()
    zero_launches(own)
    with collectives.recording() as rec:
        logits, _ = b.fn(*b.args)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(M_TIMED)]
    for a, z in ev:
        a.record()
        logits, _ = b.fn(*b.args)
        z.record()
    torch.cuda.synchronize()
    flash = read_launches("flash_attention", device=own)["flash_attention"]
    peak = torch.cuda.max_memory_allocated() - base
    finite = bool(torch.isfinite(logits).all())
    # one more step, profiled on rank 0 (the others run it unprofiled:
    # the collectives need every rank)
    prof = None
    if mesh.coords == {a: 0 for a in mesh.axis_names}:
        prof = profile_summary(lambda: b.fn(*b.args))
    else:
        b.fn(*b.args)
        torch.cuda.synchronize()
    out = {"cell": name, "arch": arch_id, "shape": shape,
           "overrides": over or {}, "ms": [a.elapsed_time(z) for a, z in ev],
           "peak": peak, "dry_peak": dry["bytes_per_device"],
           "dry_memory": dry["memory"], "dry_s": round(dry_s, 2),
           "collective_bytes": rec.total, "collectives": rec.bytes,
           "dry_collective_bytes": dry["collective_bytes_per_chip"],
           "dry_collectives": dry["collectives"], "finite": finite,
           "logits": list(logits.shape), "flash": flash,
           "flash_check": flash_check,
           "steps": 1 + M_TIMED,
           "n_layers": len(b.args[0].layers), "profile": prof}
    del b, logits
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    kernels.device_launches(torch.cuda.current_device(), reset=True)
    return out


def _whole(t, spec, mesh, reduce: bool = False):
    """The whole leaf from the rank's shard ``t`` of ``spec``; with
    ``reduce`` (a rank's unreduced gradient) summed first over the axes
    its spec leaves free."""
    from repro_torch import collectives as C
    from repro_torch import sharding as sh
    from repro_torch.models.layers import gather_at_use
    if reduce:
        used = {a for i in range(t.dim()) for a in sh.spec_axes(spec, i)}
        t = C.all_reduce(t.clone(), mesh, tuple(
            a for a in mesh.axis_names if a not in used))
    return gather_at_use(t, spec, mesh)


def _train_pass(cfg, lm, batch, opt, n: int, routes=None, pins=None):
    """One AdamW step of ``lm`` on ``batch`` by hand (the loss's gradient
    at 1/``n`` of it, then ``optimizer.update``): (its metrics, the
    gradients by name, unreduced on a mesh)."""
    import torch
    from repro_torch.models import transformer_lm as tlm
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    state = ts.init_state(lm)
    loss, met = tlm.loss_fn(cfg, lm, batch, metrics=routes, expert_idx=pins)
    names = [name for name, _ in lm.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss / n,
                                                list(lm.parameters()))))
    del loss
    _, _, om = opt_lib.update(opt, grads, state["opt"], lm)
    metrics = {k: float(v.detach()) for k, v in {**met, **om}.items()}
    del state
    return metrics, grads


def mesh_train_check(mesh, arch_id: str) -> dict:
    """Check 3 on one rank: one AdamW step of ``arch_id`` at full width
    and M_CHECK_LAYERS layers in fp32 on ``attn_impl="flash"``, on rank 0's
    card alone and then on ``mesh`` (the seed-0 draw cut to the rank's
    shards, the batch's rows by ``shard_batch``); rank 0 compares the
    metrics, every gradient gathered from the shards (summed over the
    ranks that hold its leaf alike) and every parameter after the step.
    An MoE LM whose picks on the mesh differ from the one-card step's is
    held with its routes pinned to them; the share of equal picks is
    reported."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer_lm as tlm
    from repro_torch.train import optimizer as opt_lib
    cfg = dataclasses.replace(get_arch(arch_id).model_cfg(),
                              n_layers=M_CHECK_LAYERS, dtype=torch.float32,
                              attn_impl="flash")
    dev = mesh.device
    g = torch.Generator(dev).manual_seed(2)
    B, S = M_TRAIN_BATCH, M_TRAIN_SEQ
    batch = {k: torch.randint(0, cfg.vocab, (B, S), device=dev, generator=g)
             for k in ("tokens", "targets")}
    batch["targets"][:, -1] = -1
    opt = opt_lib.AdamWConfig(lr=M_TRAIN_LR, warmup_steps=1, total_steps=10)
    rank0 = mesh.coords == {a: 0 for a in mesh.axis_names}
    one, routes = {}, []
    if rank0:
        lm = tlm.init_params(cfg, torch.Generator(dev).manual_seed(0))
        one["metrics"], grads = _train_pass(cfg, lm, batch, opt, 1, routes)
        one["grads"] = {k: v.detach() for k, v in grads.items()}
        one["params"] = {k: p.detach() for k, p in lm.named_parameters()}
        del lm, grads
    pins = None
    if cfg.moe:
        pins = [torch.empty(B * S, cfg.moe.top_k, dtype=torch.int64,
                            device=dev) for _ in range(M_CHECK_LAYERS)]
        for i, t in enumerate(pins):
            if rank0:
                t.copy_(routes[i]["expert_idx"])
            dist.broadcast(t, 0)
    lm = tlm.init_params(cfg, torch.Generator(dev).manual_seed(0), mesh=mesh)
    local = tlm.shard_batch(cfg, mesh, batch, 1)
    out = {"arch": arch_id, "dtype": "float32", "attn_impl": "flash",
           "batch": [B, S], "pinned": False}
    if cfg.moe:
        seen = []
        with torch.no_grad():
            tlm.loss_fn(cfg, lm, local, metrics=seen)
        same = sum(int((m["expert_idx"] == p).sum())
                   for m, p in zip(seen, pins))
        out["route_agree"] = same / sum(p.numel() for p in pins)
        out["pinned"] = out["route_agree"] < 1.0
    metrics, grads = _train_pass(cfg, lm, local, opt, mesh.size,
                                 pins=pins if out["pinned"] else None)
    whole_g = {k: _whole(v.detach(), lm.spec(k), mesh, reduce=True)
               for k, v in grads.items()}
    del grads
    whole_p = {k: _whole(p.detach(), lm.spec(k), mesh)
               for k, p in lm.named_parameters()}
    del lm
    if rank0:
        out["metrics"] = metrics
        out["metrics_one_card"] = one["metrics"]
        out["metric_rel"] = {
            k: abs(metrics[k] - v) / max(abs(v), 1e-30)
            for k, v in one["metrics"].items() if k != "lr"}
        grad_rel, param_excess = {}, {}
        for k, w in one["grads"].items():
            grad_rel[k] = float(torch.linalg.vector_norm(whole_g[k] - w)
                                / torch.linalg.vector_norm(w).clamp_min(
                                    1e-30))
            floor = w.abs() < 1e-4 * w.abs().max()
            want = one["params"][k]
            err = (whole_p[k] - want).abs()
            bound = torch.where(floor, torch.full_like(err, M_TRAIN_LR),
                                1e-5 + 1e-4 * want.abs().max())
            param_excess[k] = float((err / bound).max())
        out["grad_rel"] = max(grad_rel.values())
        out["grad_rel_leaf"] = max(grad_rel, key=grad_rel.get)
        out["param_excess"] = max(param_excess.values())
        out["param_excess_leaf"] = max(param_excess, key=param_excess.get)
        out["ok"] = (all(r <= M_TRAIN_RTOL
                         for r in out["metric_rel"].values())
                     and out["grad_rel"] <= M_TRAIN_GRAD_REL
                     and out["param_excess"] <= 1.0
                     and math.isfinite(metrics["ce"]))
    del one, whole_g, whole_p
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def mesh_train_cell(mesh) -> dict:
    """Cell M4 on one rank: the smallest micro-batch count of M4_MICRO
    whose dry run at the rank's coordinates fits the card, the flash
    kernel at the rank's shapes of it against its plain version
    (:func:`mesh_flash_check`), then the bundle on ``mesh``: one warm-up
    step (its collectives recorded) and one step between CUDA events, the
    rank's peak memory above what it held before the build, the flash
    kernel's launches over both, and the loss and gradient norm of
    each."""
    import torch
    import torch.distributed as dist
    from repro_torch import collectives
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.steps import build_bundle
    name, arch_id, shape, over = M4
    shape_only = mesh_lib.Mesh(tuple(mesh.shape.values()), mesh.axis_names,
                               coords=mesh.coords)
    t0 = time.perf_counter()
    tried = {}
    for n in M4_MICRO:
        o = {**over, "train_microbatches": str(n)}
        dry, shapes = _flash_shapes(lambda: run_cell(
            arch_id, shape, mesh=shape_only, overrides=o, verbose=False),
            "flash_attention_xla")
        tried[n] = dry["bytes_per_device"]
        if dry["bytes_per_device"] <= mesh_lib.memory_bytes():
            break
    else:
        raise AssertionError(f"M4: no micro-batch count of {M4_MICRO} fits "
                             f"a card: dry-run peaks {tried}")
    dry_s = time.perf_counter() - t0
    flash_check = mesh_flash_check(shapes, 11 + dist.get_rank())
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    b = build_bundle(arch_id, shape, mesh=mesh, overrides=o)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    own = torch.cuda.current_device()
    zero_launches(own)
    state, batch = b.args
    with collectives.recording() as rec:
        state, m0 = b.fn(state, batch)
    a, z = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    state, m1 = b.fn(state, batch)
    z.record()
    torch.cuda.synchronize()
    flash = read_launches("flash_attention", device=own)["flash_attention"]
    peak = torch.cuda.max_memory_allocated() - base
    steps = [{k: float(v) for k, v in m.items()} for m in (m0, m1)]
    out = {"cell": name, "arch": arch_id, "shape": shape, "overrides": o,
           "micro": n, "dry_peaks_tried": tried, "ms": a.elapsed_time(z),
           "peak": peak, "dry_peak": dry["bytes_per_device"],
           "dry_memory": dry["memory"], "dry_s": round(dry_s, 2),
           "build_s": round(build_s, 2),
           "collective_bytes": rec.total, "collectives": rec.bytes,
           "dry_collective_bytes": dry["collective_bytes_per_chip"],
           "dry_collectives": dry["collectives"],
           "dry_flops": dry["flops_per_chip"], "metrics": steps,
           "finite": all(math.isfinite(s["ce"]) and
                         math.isfinite(s["grad_norm"]) for s in steps),
           "flash": flash, "flash_check": flash_check,
           "n_layers": len(state["params"].layers), "steps": 2,
           "tokens": int(batch["tokens"].numel()),
           "global_tokens": int(batch["rows"] * batch["tokens"].shape[1])}
    del b, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def mesh_rank(rank: int, world: int, port: int, out_dir: str) -> int:
    """One rank of phase M (``chip_smoke.py --mesh-rank``): joins the NCCL
    group on card ``rank``, runs checks 1 and 3 on the mesh of all ranks
    and, with 4, check 2's cells and cell M4 on the 2x2 mesh; writes its
    results to ``<out_dir>/rank<rank>.json``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_cards(rank, world, f"tcp://localhost:{port}")
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = M_SHAPE if world == 4 else (1, world)
    mesh = mesh_lib.make_card_mesh(shape)
    res = {"rank": rank, "coords": mesh.coords, "mesh": mesh.name,
           "device": str(mesh.device), "check": [], "train_check": [],
           "cells": []}
    t0 = time.perf_counter()
    for arch_id, over in M_CHECK_ARCHS:
        res["check"].append(mesh_check(mesh, arch_id, over))
    res["check_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    for arch_id in M_TRAIN_ARCHS:
        res["train_check"].append(mesh_train_check(mesh, arch_id))
    res["train_check_s"] = round(time.perf_counter() - t0, 2)
    if world == 4:
        for cell in M_CELLS:
            res["cells"].append(mesh_cell(mesh, *cell))
        res["m4"] = mesh_train_cell(mesh)
    res["s"] = round(time.perf_counter() - t0, 2)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_mesh(smi: str) -> dict:
    """Phase M: the LM serve and train steps on a mesh of cards, one
    process a card (NCCL).  The kernels are built in this process first;
    the card is freed before the ranks start.  Check 1 on a mesh of the
    cards present (2x2 with 4 or more, 1 x n else): qwen2-1.5b,
    internlm2-1.8b (on the flash kernel) and olmoe-1b-7b (its routes
    pinned) at full width and 2 layers in bf16, a prefill and a decode
    step against rank 0's card alone.  Check 3 on the same mesh: one
    AdamW step of the same LMs in fp32 on the flash training path against
    rank 0's card alone (:func:`mesh_train_check`).  With 4 cards, cell
    M4 (:func:`mesh_train_cell`: qwen2-1.5b x train_4k at full width and
    depth, each rank's peak within M_PEAK_REL of its dry run, its flash
    launches equal on every rank) after check 2: cells M1-M3 at
    full depth on the 2x2 mesh, each rank's peak memory within
    M_PEAK_REL of its dry run, the collective bytes a step beside the dry
    run's, M2's flash kernel at each rank's shapes against its plain
    version and its launches equal on every rank (the layers a step),
    finite logits, ms a step.  Returns the flash launches of all ranks'
    check-2 and M4 steps."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    _build.library()
    n = torch.cuda.device_count()
    world = 4 if n >= 4 else n
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = Path(__file__).resolve().parent / "build" / "mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("rank*.json"):
        old.unlink()
    port = mesh_lib.free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--mesh-rank", str(r), str(world), str(port),
                               str(out_dir)]) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=M_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * world, f"phase M ranks exited {rcs}"
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(world)]
    log(f"[M] {world} ranks on the {ranks[0]['mesh']} mesh "
        f"({n} cards present), {time.perf_counter() - t0:.1f} s; "
        f"check 1 {ranks[0]['check_s']} s; {smi}")
    bad = []
    for c in ranks[0]["check"]:
        log(f"[M check] {c['arch']} {c['overrides'] or ''} (full width, "
            f"{M_CHECK_LAYERS} layers, batch {M_CHECK_BATCH}, prompt "
            f"{M_CHECK_PROMPT}, cache {M_CHECK_CACHE}, {c['dtype']}) shards "
            f"{c['shards']}: mesh vs rank 0's card alone (limits: relative "
            f"{M_CHECK_REL}, argmax agree >= {M_CHECK_ARGMAX_MIN}): prefill "
            f"{c['prefill']}, decode {c['decode']}" + (
                f"; routes pinned to the one-card run's, dropped a layer "
                f"{c['dropped']} (one card {c['dropped_one_card']}); "
                f"unpinned, expert picks equal to the one-card run's "
                f"{c['route_agree']}" if "route_agree" in c else ""))
        for step in ("prefill", "decode"):
            r = c[step]
            if not r["finite"] or r["rel"] > M_CHECK_REL or \
                    r["argmax_agree"] < M_CHECK_ARGMAX_MIN:
                bad.append((c["arch"], step, r))
        if "dropped" in c and c["dropped"] != c["dropped_one_card"]:
            bad.append((c["arch"], "dropped", c["dropped"],
                        c["dropped_one_card"]))
    for c in ranks[0]["train_check"]:
        log(f"[M check 3] {c['arch']} (full width, {M_CHECK_LAYERS} layers, "
            f"batch {c['batch']}, {c['dtype']}, {c['attn_impl']}) one AdamW "
            f"step on the mesh vs rank 0's card alone (limits: metrics "
            f"relative {M_TRAIN_RTOL}, gradients relative norm "
            f"{M_TRAIN_GRAD_REL}, parameters the floor rule, <= 1 of their "
            f"bound): metrics {c['metrics']} vs {c['metrics_one_card']}, "
            f"relative {c['metric_rel']}; gradients worst {c['grad_rel']:.3e}"
            f" ({c['grad_rel_leaf']}); parameters worst "
            f"{c['param_excess']:.4f} of their bound "
            f"({c['param_excess_leaf']})" + (
                f"; expert picks unpinned equal to the one-card step's "
                f"{c['route_agree']}, held "
                f"{'pinned' if c['pinned'] else 'unpinned'}"
                if "route_agree" in c else ""))
        if not c["ok"]:
            bad.append(("check 3", c["arch"]))
    log(f"[M check 3] {ranks[0]['train_check_s']} s on rank 0")
    flash = 0
    if world < 4:
        assert not bad, bad
        log(f"[M] cells M1-M4 did not run: they need 4 cards and "
            f"{n} {'is' if n == 1 else 'are'} present")
        return {"flash": 0}
    for i, (name, arch_id, shape, over) in enumerate(M_CELLS):
        cells = [r["cells"][i] for r in ranks]
        for r, c in enumerate(cells):
            ratio = c["peak"] / c["dry_peak"]
            log(f"[M {name}] rank {r} {ranks[r]['coords']}: {arch_id} x "
                f"{shape} {over or ''} {c['n_layers']} layers, logits "
                f"{c['logits']} finite {c['finite']}; ms a step {c['ms']}; "
                f"peak {c['peak']} bytes, dry run {c['dry_peak']} (memory "
                f"{c['dry_memory']}; {c['dry_s']} s), measured / dry run "
                f"{ratio:.4f}; collective bytes a step {c['collective_bytes']}"
                f" {c['collectives']}, dry run {c['dry_collective_bytes']} "
                f"{c['dry_collectives']}; flash launches {c['flash']}")
            if not c["finite"] or abs(ratio - 1) > M_PEAK_REL:
                bad.append((name, r, c["finite"], ratio))
        for r, c in enumerate(cells):
            for f in c["flash_check"]:
                log(f"[M {name}] rank {r}: flash kernel at the rank's shape "
                    f"q {f['q']} k/v {f['k']} {f['dtype']} causal "
                    f"{f['causal']} chunk {f['chunk']} against its plain "
                    f"version on (batch, kv head) groups {f['groups']}: max "
                    f"abs err {f['max_abs_err']:.4f} (2e-2), relative "
                    f"{f['rel']:.3e} ({REL_TOL}), worst element "
                    f"{f['row']:.3f} of its allowance; {f['ms']:.4f} ms, "
                    f"bound {f['bound_ms']:.4f} ms, "
                    f"{f['bound_ms'] / f['ms']:.3f} of it; plain version "
                    f"on one group {f['plain_ms_one_group']:.4f} ms, "
                    f"library {f['library_ms']} ms; {smi}")
                if not f["ok"]:
                    bad.append((name, r, "flash check", f))
        if over and over.get("attn_impl") == "pallas" and \
                not all(c["flash_check"] for c in cells):
            bad.append((name, "flash check missing"))
        ms = [sum(c["ms"]) / len(c["ms"]) for c in cells]
        log(f"[M {name}] ms a step, mean of {M_TIMED} a rank: {ms}; max "
            f"{max(ms):.2f}; {smi}")
        log(f"[M {name}] rank 0, one more step under torch.profiler: "
            f"{cells[0]['profile']}")
        launches = {c["flash"]["device"] for c in cells} | \
            {c["flash"]["host"] for c in cells}
        # one launch a layer a prefill on every rank; none at decode
        want = cells[0]["n_layers"] * cells[0]["steps"] if over and \
            over.get("attn_impl") == "pallas" else 0
        if launches != {want}:
            bad.append((name, "flash", launches, want))
        flash += sum(c["flash"]["device"] for c in cells)
    cells = [r["m4"] for r in ranks]
    for r, c in enumerate(cells):
        ratio = c["peak"] / c["dry_peak"]
        log(f"[M M4] rank {r} {ranks[r]['coords']}: {c['arch']} x "
            f"{c['shape']} {c['overrides']}, {c['n_layers']} layers, "
            f"{c['micro']} micro-batches (dry-run peaks tried "
            f"{c['dry_peaks_tried']}), {c['tokens']} tokens a rank a step; "
            f"ms of the timed step {c['ms']:.2f}; metrics {c['metrics']}; "
            f"peak {c['peak']} bytes, dry run {c['dry_peak']} (memory "
            f"{c['dry_memory']}; {c['dry_s']} s), measured / dry run "
            f"{ratio:.4f}; collective bytes a step {c['collective_bytes']} "
            f"{c['collectives']}, dry run {c['dry_collective_bytes']} "
            f"{c['dry_collectives']}; dry-run flops {c['dry_flops']:.4g}; "
            f"build {c['build_s']} s; flash launches {c['flash']}; {smi}")
        if not c["finite"] or abs(ratio - 1) > M_PEAK_REL:
            bad.append(("M4", r, c["finite"], ratio))
        for f in c["flash_check"]:
            log(f"[M M4] rank {r}: flash kernel at the rank's shape q "
                f"{f['q']} k/v {f['k']} {f['dtype']} causal {f['causal']} "
                f"chunk {f['chunk']} against its plain version on (batch, "
                f"kv head) groups {f['groups']}: max abs err "
                f"{f['max_abs_err']:.4f} (2e-2), relative {f['rel']:.3e} "
                f"({REL_TOL}), worst element {f['row']:.3f} of its "
                f"allowance; {f['ms']:.4f} ms, bound {f['bound_ms']:.4f} ms "
                f"({f['bound_ms'] / f['ms']:.3f} of it), plain version on "
                f"one group {f['plain_ms_one_group']:.4f} ms, library "
                f"{f['library_ms']} ms; {smi}")
            if not f["ok"]:
                bad.append(("M4", r, "flash check", f))
        if not c["flash_check"]:
            bad.append(("M4", r, "flash check missing"))
    # the forward and remat's recompute of every layer, each micro-batch
    # of each step, on every rank
    want = 2 * cells[0]["n_layers"] * cells[0]["micro"] * cells[0]["steps"]
    launches = {c["flash"]["device"] for c in cells} | \
        {c["flash"]["host"] for c in cells}
    if launches != {want}:
        bad.append(("M4", "flash", launches, want))
    slowest = max(c["ms"] for c in cells)
    log(f"[M M4] ms a step a rank: {[c['ms'] for c in cells]}; max "
        f"{slowest:.2f}; tokens a second over the mesh "
        f"{cells[0]['global_tokens'] / (slowest / 1e3):.1f}; {smi}")
    flash += sum(c["flash"]["device"] for c in cells)
    assert not bad, bad
    return {"flash": flash}


# ---------------------------------------------------------------------------
# phase Q: the query engine over the local cards
# ---------------------------------------------------------------------------

#: Q1: the reference's engine-scaling workloads (benchmarks/ir_bench.py
#: ENGINE_WORKLOADS) over 256 queries tiled from the T topics, its ladder,
#: the best of Q_REPEATS timed runs after one warm-up
Q_QUERIES, Q_LADDER, Q_REPEATS = 256, (16, 64, 128), 3
#: the card counts of Q1's rows (those present)
Q_CARDS = (1, 2, 4)
#: Q0: the per-card query counts of a shard (the default ladder's 8, 16
#: and 32 over 4 cards) at which the kernels are held to their plain
#: versions on the last card
Q_SHARD_NQ = (2, 4, 8)
#: the CPU rehearsal's "cards" (chip_smoke.DEVICE = "cpu")
Q_CPU_CARDS = 4
#: the checks of Q1-Q4 that failed: each is logged where it fails, and
#: phase Q fails at its end, once every figure is printed
Q_FAILS: list = []


def q_check(ok: bool, what) -> bool:
    if not ok:
        Q_FAILS.append(what)
        log(f"[Q] FAILED: {what}")
    return ok


def q_cards() -> int:
    import torch
    return Q_CPU_CARDS if DEVICE == "cpu" else torch.cuda.device_count()


def query_mesh(n: int, doc_shards=None):
    """The query mesh of the first ``n`` cards (CPU "cards" in a
    rehearsal)."""
    from repro_torch.launch.mesh import make_query_mesh
    if DEVICE == "cpu":
        return make_query_mesh(devices=["cpu"] * n, doc_shards=doc_shards)
    return make_query_mesh(max_devices=n, doc_shards=doc_shards)


def _same_result(a: dict, b: dict) -> bool:
    """Docids, scores (and features) equal bit for bit, on the host."""
    keys = ("docids", "scores") + (("features",) if "features" in a else ())
    return all(same_bits(a[k].cpu(), b[k].cpu()) for k in keys)


def _ranking_gap(a: dict, b: dict) -> tuple[bool, int, float]:
    """(docids equal, scores whose bits differ, largest relative gap)."""
    import torch
    sa, sb = a["scores"].cpu(), b["scores"].cpu()
    fin = sa.isfinite() & sb.isfinite()
    gap = ((sa - sb).abs() / sb.abs().clamp(min=1e-30))[fin]
    return (bool(torch.equal(a["docids"].cpu(), b["docids"].cpu())),
            int((sa.view(torch.int32) != sb.view(torch.int32)).sum()),
            float(gap.max()) if gap.numel() else 0.0)


def phase_q_kernels(index, state) -> None:
    """Q0: each retrieval kernel at a card's shard of the main path's
    chunks (nq 2, 4, 8) on the last card while the first is current, held
    to its plain version bit for bit (dense_topk 1e-5); with two cards or
    more, inputs on two cards raise."""
    import torch
    from repro_torch.index import dense as DN
    from repro_torch.kernels.dense_scoring.ops import streaming_dense_topk
    from repro_torch.kernels.dense_scoring.ref import dense_topk_ref
    from repro_torch.kernels.pq_scoring.ops import streaming_pq_topk
    from repro_torch.kernels.pq_scoring.ref import pq_topk_ref
    from repro_torch.kernels.topk.ops import streaming_topk
    from repro_torch.kernels.topk.ref import streaming_topk_ref
    n = q_cards()
    last = torch.device(DEVICE) if DEVICE == "cpu" else \
        torch.device("cuda", n - 1)
    g = torch.Generator(device=DEVICE).manual_seed(25)
    emb = state["dense"].emb.to(last)
    pq = state["ivfpq"]
    for nq in Q_SHARD_NQ:
        s = torch.randn(nq, index.n_docs, device=DEVICE, generator=g).to(last)
        q = torch.randn(nq, emb.shape[1], device=DEVICE, generator=g)
        q = (q / q.norm(dim=1, keepdim=True)).to(last)
        codes = pq.codes[:6912][None].expand(nq, -1, -1).contiguous().to(last)
        table = DN.adc_table(pq.codebook, q.to(pq.codes.device)).to(last)
        for k in TOPK_KS:
            v1, i1 = streaming_topk(s, k=k)
            v2, i2 = streaming_topk_ref(s, k=k)
            assert same_bits(v1, v2) and torch.equal(i1, i2), ("topk", nq, k)
            v1, i1 = streaming_dense_topk(emb, q, k=k)
            v2, i2 = dense_topk_ref(emb, q, k=k)
            torch.testing.assert_close(v1, v2, rtol=0, atol=1e-5)
            assert float((i1 == i2).float().mean()) >= 0.99, ("dense", nq, k)
        for k in PQ_KS:
            v1, i1 = streaming_pq_topk(codes, table, k=k)
            v2, i2 = pq_topk_ref(codes, table, k=k)
            assert same_bits(v1, v2) and torch.equal(i1, i2), ("pq", nq, k)
    mixed = "no second card"
    if n > 1 and DEVICE != "cpu":
        try:
            streaming_dense_topk(emb, q.to("cuda:0"), k=10)
            raise AssertionError("a kernel with inputs on two cards ran")
        except ValueError as e:
            mixed = f"raises ({e})"
    log(f"[Q0] on {last} while {torch.cuda.current_device() if DEVICE != 'cpu' else 'cpu'} "
        f"is current: topk [nq, {index.n_docs}] and dense_topk on D2's "
        f"store at nq {Q_SHARD_NQ} x k in {TOPK_KS}, pq_topk on [nq, 6912, "
        f"{pq.codes.shape[1]}] codes at k in {PQ_KS}: equal to their plain "
        f"versions; inputs on two cards: {mixed}")


def phase_q1(index, forms, smi: str) -> None:
    """Q1: the reference's engine-scaling workloads (experiment_k1000:
    three Retrieve(k=1000) unoptimised; serving_pruned_k10: BM25 and QL
    % 10 optimised) over 256 tiled T topics, ladder (16, 64, 128), on 1,
    2 and 4 cards and on the sequential loop (chunks of 8, a barrier each
    stage): queries/s, speedup, rankings bit-equal to one card's (read
    once before any barrier), entries per stage <= 3."""
    import numpy as np
    import repro_torch as rt
    from repro_torch.core.compiler import Context
    from repro_torch.core.plan import ExperimentPlan
    topics = forms["T"]
    reps = Q_QUERIES // len(topics.qids) + 1
    Q = rt.make_queries(np.tile(np.asarray(topics.terms), (reps, 1))[:Q_QUERIES],
                        np.tile(np.asarray(topics.weights),
                                (reps, 1))[:Q_QUERIES],
                        np.arange(Q_QUERIES, dtype=np.int32), device=DEVICE)
    workloads = {
        "experiment_k1000": ([rt.Retrieve("BM25", k=1000),
                              rt.Retrieve("QL", k=1000),
                              rt.Retrieve("TF_IDF", k=1000)], False),
        "serving_pruned_k10": ([rt.Retrieve("BM25") % 10,
                                rt.Retrieve("QL") % 10], True)}
    counts = [c for c in Q_CARDS if c <= q_cards()]

    def timed(plan, be, record):
        res = plan.execute(Q, ctx=Context(be), record=record)
        be.barrier(res)
        best = float("inf")
        for _ in range(Q_REPEATS):
            t0 = time.perf_counter()
            res = plan.execute(Q, ctx=Context(be), record=record)
            be.barrier(res)
            best = min(best, time.perf_counter() - t0)
        return best, res

    seq = rt.TorchBackend(index, default_k=1000, query_chunk=8,
                          sharded=False, device=DEVICE)
    for name, (pipes, optimize) in workloads.items():
        work = Q_QUERIES * len(pipes)
        t_seq, want = timed(ExperimentPlan(pipes, seq, optimize=optimize),
                            seq, "cold")
        rows, one = [], None
        for c in counts:
            be = rt.TorchBackend(index, default_k=1000, engine=rt.ShardedQueryEngine(
                query_mesh(c), ladder=Q_LADDER))
            plan = ExperimentPlan(pipes, be, optimize=optimize)
            # read before any barrier: the peer copies into the home card
            # are ordered behind each card's work
            first = plan.execute(Q, ctx=Context(be), record=None)
            first = [{k: v.cpu() for k, v in r.items()} for r in first]
            t, res = timed(plan, be, None)
            one = res if one is None else one
            gaps = [_ranking_gap(a, b) for a, b in
                    zip(list(res) + list(first), list(one) + list(one))]
            eq = q_check(all(g[0] and g[1] == 0 for g in gaps),
                         ("Q1 bit-equal to one card", name, c, gaps))
            eng = be.engine
            q_check(eng.max_compiles_per_stage() <= len(Q_LADDER),
                    ("Q1 entries a stage", name, c,
                     eng.max_compiles_per_stage()))
            rows.append({"cards": c, "qps": round(work / t, 1),
                         "speedup_vs_sequential": round(t_seq / t, 3),
                         "max_recompiles_per_stage":
                             eng.max_compiles_per_stage(),
                         "bit_equal_to_one_card": eq})
            del be, plan, res, first
        same_seq = all(_ranking_gap(a, b)[0] for a, b in zip(one, want))
        log(f"[Q1] {name}: {len(pipes)} pipelines x {Q_QUERIES} queries, "
            f"ladder {Q_LADDER}; sequential (chunks of 8) "
            f"{round(work / t_seq, 1)} queries/s; {rows}; docids of one card "
            f"equal to the sequential loop's: {same_seq}; {smi}")
    if q_cards() < max(Q_CARDS):
        log(f"[Q1] the rows of {[c for c in Q_CARDS if c > q_cards()]} "
            f"cards did not run: {q_cards()} card(s) present")


def phase_q2(index, forms, state, smi: str) -> dict:
    """Q2: the main path on every card present against one card: RQ1
    kernels, RQ2 optimised, D1-D4 optimised on the 250 T topics at the
    default ladder, docids and scores bit-equal; the retrieval kernels'
    launches counted on each card (above 0 on every one); MRT on one card
    and on n.  Returns the launch window of the n-card runs."""
    import torch
    import repro_torch as rt
    from repro_torch import kernels
    from repro_torch.core import BackendDescriptor
    from repro_torch.index.robust04 import NPROBE, PQ_M, PQ_REFINE
    n = q_cards()
    topics = forms["T"]
    Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                        device=DEVICE)
    kcaps = BackendDescriptor.default({"fat", "fused_topk", "fused_scoring"})
    #: the backends' state: RQ1 on the kernels' caps, RQ2 and D1-D3 on
    #: the flat and IVF state, D4 on IVF-PQ
    kinds = {"kernels": {"descriptor": kcaps},
             "dense": {"dense": state["dense"], "ivf": state["ivf"]},
             "pq": {"dense": state["dense"], "ivfpq": state["ivfpq"],
                    "pq_m": PQ_M, "pq_refine": PQ_REFINE}}
    cells = {
        "RQ1 kernels": (rt.Retrieve("BM25") % 10, "kernels",
                        "fused_topk_retrieve"),
        "RQ2 optimised": ((rt.Retrieve("BM25") >> (rt.Extract("QL") **
                                                   rt.Extract("TF_IDF")))
                          % 1000, "dense", "fused_fat_retrieve"),
        "D1": ((rt.Retrieve("BM25", k=200) >> rt.DenseRerank(alpha=0.3))
               % 10, "dense", "fused_dense_rerank"),
        "D2": (rt.DenseRetrieve(k=10, nprobe=0) % 10, "dense",
               "fused_dense_retrieve"),
        "D3": (rt.DenseRetrieve(k=10, nprobe=NPROBE) % 10, "dense",
               "fused_dense_retrieve"),
        "D4": (rt.DenseRetrieve(k=10, nprobe=NPROBE, pq=True) % 10, "pq",
               "fused_dense_retrieve")}

    def experiment(pipe, be):
        r = rt.Experiment([pipe], Q, topics.qrels, ["map"], backend=be,
                          optimize=True, measure_time=True)
        return r["table"][0], r["results"][0]

    ones = {k: rt.TorchBackend(index, default_k=1000, device=DEVICE, **kw)
            for k, kw in kinds.items()}
    one = {}
    for name, (pipe, kind_of, kind) in cells.items():
        assert compile_checked(pipe, ones[kind_of]).kind == kind, name
        one[name] = experiment(pipe, ones[kind_of])
    del ones
    eng = rt.ShardedQueryEngine(query_mesh(n))
    bes = {k: rt.TorchBackend(index, default_k=1000, engine=eng, **kw)
           for k, kw in kinds.items()}
    for name, (pipe, kind_of, kind) in cells.items():
        assert compile_checked(pipe, bes[kind_of]).kind == kind, name
        experiment(pipe, bes[kind_of])     # each card's replica, built
    names = ("topk", "fused_scoring", "dense_topk", "pq_topk")
    zero_launches()
    out = {}
    for name, (pipe, kind_of, _) in cells.items():
        out[name] = experiment(pipe, bes[kind_of])
    window = read_launches(*names)
    cards = eng.cards if DEVICE != "cpu" else []
    per_card = {str(c): kernels.device_launches(c) for c in cards}
    for c, counts in per_card.items():
        for k in names:
            q_check(counts[k] > 0, f"Q2: kernel {k} did not run on {c}")
    for name in cells:
        (r1, R1), (rn, Rn) = one[name], out[name]
        eq = q_check(_same_result(R1, Rn), (
            f"Q2 {name}: {n} cards against one (docids equal, score bits "
            f"off, largest relative gap)", _ranking_gap(R1, Rn)))
        log(f"[Q2] {name}: {n} card(s) bit-equal to one card {eq}; map "
            f"{rn['map']:.4f}; mrt_ms one card {r1['mrt_ms']:.4f}, {n} "
            f"card(s) {rn['mrt_ms']:.4f}; {smi}")
    log(f"[Q2] launches on the {n}-card runs: {window}; on each card "
        f"(counted by the kernels): {per_card}; {smi}")
    return window


def phase_q3(state) -> None:
    """Q3: D2's store cut into doc shards on a ("data", "docs") mesh
    (2x2 on 4 cards; 1 x n below), each shard copied to its group's
    cards: bit-equal to the unsharded search."""
    import torch
    import repro_torch as rt
    from repro_torch.core.engine import StageProgram
    from repro_torch.index import dense as DN
    n = min(q_cards(), 4)
    docs = 2 if n >= 2 else 1
    eng = rt.ShardedQueryEngine(query_mesh(n, doc_shards=docs))
    dense = state["dense"]
    g = torch.Generator(device=DEVICE).manual_seed(3)
    qv = torch.randn(250, dense.dim, device=DEVICE, generator=g)
    qv = qv / qv.norm(dim=1, keepdim=True)
    k = 10
    want = DN.dense_retrieve_exact_fused(dense, qv, k=k)
    for n_shards in sorted({docs, 2 * docs}):
        progs = []
        for copies, off in DN.shard_dense_index(dense, n_shards,
                                                devices=eng.mesh.devices):
            kk = min(k, int(copies[0].emb.shape[0]))

            def bound(i, copies=copies, off=off, kk=kk):
                def fn(q):
                    d, v = DN.dense_retrieve_exact_fused(copies[i], q, k=kk)
                    return d + off, v
                return fn
            progs.append(StageProgram(key=("Q3", n_shards, off),
                                      fn=bound(0), bind=bound))
        got_d, got_v = eng.run_doc_sharded(progs, None, qv, k=k)
        eq = q_check(np_equal(got_d, want[0]) and np_equal(got_v, want[1]),
                     f"Q3: {n_shards} shards against unsharded D2")
        log(f"[Q3] D2's store in {n_shards} doc shards on the "
            f"{eng.mesh.name} {eng.mesh.axis_names} mesh: bit-equal to the "
            f"unsharded search {eq} (250 queries, k={k})")


def np_equal(a, b) -> bool:
    import numpy as np
    a = np.asarray(a)
    b = b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    return a.shape == b.shape and bool((a == b).all())


def phase_q4(index, forms) -> None:
    """Q4: S1's tenants ql and top10 served on the n-card engine: results
    bit-equal to run_pipeline's, no entry made after warm-up."""
    import numpy as np
    import repro_torch as rt
    from repro_torch.core import BackendDescriptor, ir
    from repro_torch.core.descriptor import DEFAULT_CAPABILITIES
    n = q_cards()
    desc = BackendDescriptor.default(DEFAULT_CAPABILITIES - {"pruned_topk"})
    be = rt.TorchBackend(index, default_k=1000, descriptor=desc,
                         engine=rt.ShardedQueryEngine(query_mesh(n)))
    server = rt.MultiPipelineServer(
        {"ql": rt.Retrieve("BM25", k=100) >> rt.Extract("QL")}, be,
        rt.ServeConfig.default(optimize=False, max_queue=4096))
    server.add_pipeline(rt.Retrieve("BM25") % 10, name="top10",
                        optimize=True)
    assert [op.kind for op in ir.chain(compile_checked(
        rt.Retrieve("BM25") % 10, be))] == ["fused_topk_retrieve"]
    T = rt.make_queries(forms["T"].terms, forms["T"].weights,
                        forms["T"].qids, device=DEVICE)
    server.warmup({k: v[:1] for k, v in T.items()})
    t0 = time.perf_counter()
    reqs = {}
    for name in ("ql", "top10"):
        reqs[name] = server.submit(T, pipeline=name)
        server.pump()
    for name, pipe, opt in (("ql", rt.Retrieve("BM25", k=100) >>
                             rt.Extract("QL"), False),
                            ("top10", rt.Retrieve("BM25") % 10, True)):
        res = [r.wait(60) for r in reqs[name]]
        want = rt.run_pipeline(pipe, T, backend=be, optimize=opt)
        for key in ("docids", "scores"):
            got = np.concatenate([r[key] for r in res])
            q_check(np_equal(got, want[key]), f"Q4: served {name} {key}")
    s = server.stats()
    q_check(s["recompiles_since_warmup"] == 0,
            f"Q4: {s['recompiles_since_warmup']} entries after warm-up")
    log(f"[Q4] S1's ql and top10 served on {n} card(s): "
        f"{int(T['qid'].shape[0])} T topics each "
        f"in {time.perf_counter() - t0:.2f} s, results bit-equal to "
        f"run_pipeline's, recompiles since warm-up "
        f"{s['recompiles_since_warmup']}, engine devices "
        f"{s['engine']['devices']}")


def phase_q5() -> None:
    """Q5 (host): the fat-postings step per card of the production
    meshes, priced on ``meta``."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import pipeline_dryrun
    for multi_pod in (False, True):
        rec = pipeline_dryrun.run(mesh_lib.make_production_mesh(
            multi_pod=multi_pod))
        assert rec["fits"] and rec["collectives"].get("all-gather"), rec
        log(f"[Q5] fat step per card of {rec['mesh']} ({rec['n_chips']} "
            f"cards): peak {rec['bytes_per_device']} bytes (fits "
            f"{rec['fits']}), flops {rec['flops_per_chip']:.4g}, bytes "
            f"{rec['bytes_per_chip']:.4g}, collectives {rec['collectives']}"
            f"; t_compute {rec['t_compute']:.4g} s, t_memory "
            f"{rec['t_memory']:.4g} s, t_collective {rec['t_collective']:.4g}"
            f" s (host, the op counter)")


def phase_query_mesh(index, forms, state, smi: str) -> dict:
    """Phase Q: the query engine over the cards present (Q0-Q5); returns
    the launch window of Q2's n-card main path."""
    t0 = time.perf_counter()
    phase_q_kernels(index, state)
    phase_q1(index, forms, smi)
    window = phase_q2(index, forms, state, smi)
    phase_q3(state)
    phase_q4(index, forms)
    phase_q5()
    n = q_cards()
    if n < 4:
        log(f"[Q] {n} card(s) present: Q1's rows of more cards, and Q2-Q4 "
            f"across cards, did not run (they need 2 and 4 cards); Q1-Q4 "
            f"ran on the {n}-card mesh through the multi-card code")
    log(f"[Q] phase Q {time.perf_counter() - t0:.1f} s; {smi}")
    assert not Q_FAILS, Q_FAILS
    return window


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--mesh-rank"]:
        return mesh_rank(int(argv[1]), int(argv[2]), int(argv[3]), argv[4])
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

    # the plain versions' matmuls in full fp32, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_toolchain()
    log(f"[toolchain] card: {smi}")
    if argv == ["--phase", "M"]:
        # phase M alone (the 4-card run of cells M1-M4)
        mesh = phase_mesh(smi)
        log(f"[done] phase M alone {time.perf_counter() - t_start:.1f} s; "
            f"flash launches of the ranks' cells {mesh['flash']}")
        log(smi)
        return 0
    if argv == ["--phase", "Q"]:
        # phase Q alone (the query engine on the cards present: Q1's 2-
        # and 4-card rows with 4 cards), on an index and dense state of
        # its own
        index, forms = phase_index()
        state = phase_dense_build(index)
        window = phase_query_mesh(index, forms, state, smi)
        log(f"[done] phase Q alone {time.perf_counter() - t_start:.1f} s; "
            f"launches of Q2's main path over the cards {window}")
        log(smi)
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    floor = phase_floor()
    phase_small_parity()
    index, forms = phase_index()
    rows = phase_kernels(index, forms)

    # the main path: counts from zero, read right after RQ1 + RQ2.  Each
    # kernel's "launches" in the kernels line is the count its kernel keeps
    # on the card, summed over the main paths' windows
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rq1 = phase_rq1(index, forms)
    at_rq1 = read_launches("topk", "fused_scoring")
    phase_rq2(index, forms)
    windows = [read_launches("topk", "fused_scoring")]
    log(f"[main] RQ1+RQ2 {time.perf_counter() - t0:.1f} s; launches "
        f"{windows[-1]} (RQ1 {at_rq1}); peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    assert_eager_launches(windows[-1], "the RQ1+RQ2 path")

    phase_rq1_sequential(*rq1)
    del rq1

    # the rest of the paper's Experiment surface (cells L1 and P1):
    # fused_scoring counted from zero around L1's Experiment, in phase_l1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    l1 = phase_l1(index, forms)
    windows.append(l1["launches"])
    phase_tuning(forms, l1)
    phase_planner(forms, l1)
    log(f"[main] L1, CV, grid search, P1 and the artifact cache "
        f"{time.perf_counter() - t0:.1f} s; fused_scoring launches in L1's "
        f"Experiment {l1['launches']['fused_scoring']}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    del l1

    state = phase_dense_build(index)
    rows.update(phase_dense_kernels(index, forms, state))
    # the dense main path: counts from zero, read right after D1-D4
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    phase_dense(forms, state)
    windows.append(read_launches("dense_topk", "pq_topk"))
    log(f"[main] dense D1-D4 {time.perf_counter() - t0:.1f} s; launches "
        f"{windows[-1]}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    assert_eager_launches(windows[-1], "the dense path")
    # cell A1 and the doc-sharded D2 check, outside the main path's
    # windows: A1 counts its own launches from zero
    phase_autotune(index, forms, state, smi)
    phase_doc_sharded(forms, state)

    rows.update(phase_attention_kernels())
    phase_attention_shapes()
    phase_moe_layers()
    # the RAG main path (cell G1): its counts are set to zero and read
    # inside phase_generate, around its Experiment
    g1 = phase_generate(index, forms, state)
    windows.append(g1["launches"])
    # the served main path (cell S1): its counts are set to zero and read
    # inside phase_serve, around its traffic, and added to each kernel's
    t0 = time.perf_counter()
    windows.append(phase_serve(index, forms, state, g1))
    log(f"[main] S1 phase {time.perf_counter() - t0:.1f} s")
    # the MoE cells G2 and G3, each on its own LM once G1's is gone: their
    # counts are set to zero and read inside phase_generate_moe
    del g1
    for cell in (G2, G3):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        windows += phase_generate_moe(index, forms, state, cell)["windows"]
        log(f"[main] {cell.name} phase {time.perf_counter() - t0:.1f} s; "
            f"device memory held after it {torch.cuda.memory_allocated()} "
            f"bytes")
    # the training path once G3's LM is gone: the flash Function against
    # its plain version, then cell T1 (its counts set to zero and read
    # inside phase_train_t1, around train_lm), then StepGuard's replay
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flash_row = phase_flash_train(torch.Generator(DEVICE).manual_seed(21),
                                  smi)
    windows.append(phase_train_t1(smi, flash_row))
    phase_stepguard(smi)
    log(f"[main] training phases {time.perf_counter() - t0:.1f} s")
    # phase Z, the model zoo at its published widths, once T1 and
    # StepGuard have freed the card (no kernel of the port runs in it);
    # nothing reads the index or the dense state again
    del index, forms, state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_zoo_reduced()
    phase_zoo_recsys(smi)
    phase_zoo_gat(smi)
    log(f"[main] zoo phases {time.perf_counter() - t0:.1f} s")
    # phase X, the launch layer and the examples: flash at d_head 32, the
    # examples at their own sizes (each counted from zero around its run),
    # serve_demo, and qwen2-1.5b's full-width serve bundles against their
    # dry runs
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_flash_d32(smi)
    windows += phase_examples(smi)
    phase_serve_demo()
    phase_lm_bundles(smi)
    log(f"[main] phase X {time.perf_counter() - t0:.1f} s")
    # phase M, the LM serve and train steps on a mesh of the cards
    # present: each rank's flash launches of cells M1-M4 join the flash
    # row
    t0 = time.perf_counter()
    mesh = phase_mesh(smi)
    windows.append({"flash_attention": {"device": mesh["flash"],
                                        "host": mesh["flash"]}})
    log(f"[main] phase M {time.perf_counter() - t0:.1f} s")
    # phase Q, the query engine over the cards present, on an index and
    # dense state of its own (phase Z freed the earlier ones): the
    # launches of Q2's main path, summed over the cards, join the rows
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    index, forms = phase_index()
    state = phase_dense_build(index)
    windows.append(phase_query_mesh(index, forms, state, smi))
    del index, forms, state
    log(f"[main] phase Q {time.perf_counter() - t0:.1f} s (index and dense "
        f"state included)")
    launches = {}
    for w in windows:
        for name, c in w.items():
            tot = launches.setdefault(name, {"device": 0, "host": 0})
            for side in tot:
                tot[side] += c[side]

    log(f"[gate] decisions on the main paths' compiles by source: "
        f"{GATE_SOURCES} (none estimate_failed)")
    log(json.dumps({"tpu_kernels": [
        {"function": f, "status": s, "replaces": r}
        for f, s, r in TPU_KERNELS]}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    sources = {"topk": ("topk", "src/repro_torch/csrc/topk.cu",
                        TPU_KERNELS[0][2]),
               "fused_scoring": ("fused_scoring",
                                 "src/repro_torch/csrc/fused_scoring.cu",
                                 TPU_KERNELS[1][2]),
               "dense_topk": ("dense_topk D2",
                              "src/repro_torch/csrc/dense_topk.cu",
                              TPU_KERNELS[2][2]),
               "pq_topk": ("pq_topk D4", "src/repro_torch/csrc/pq_topk.cu",
                           TPU_KERNELS[3][2]),
               "flash_attention": ("flash_attention",
                                   "src/repro_torch/csrc/"
                                   "flash_attention_sm90.cu",
                                   TPU_KERNELS[4][2])}
    kernels = []
    for name, (row, src, rep) in sources.items():
        r = rows[row]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep,
                        "launches": launches[name]["device"],
                        "host_launches": launches[name]["host"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"],
                        # an empty launch's time: the floor under "ms"
                        "floor_ms": floor["one block" if name != "pq_topk"
                                          else "pq grid"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
