#!/usr/bin/env python3
"""The top-k, dense-scoring and PQ-scoring kernels of several source trees
of the port, timed in turns on one card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 benchmarks/torch_topk_ab.py TREE [TREE ...] [--order 0,1,1,0]

Each TREE holds a ``src/repro_torch`` package: ``.`` for this checkout, or
a copy of another commit's (``git archive <commit> src/repro_torch | tar -x
-C TREE``) or of a variant.  The trees' ``csrc/topk.cu``,
``csrc/dense_topk.cu`` and ``csrc/pq_topk.cu`` are built at once, each
into the tree's ``build/topk_ab/``; then one process per entry of
``--order`` (indices into the trees, default each tree once) times, with
that tree's own wrappers and ``chip_smoke.time_ms``, two readings each of

- ``streaming_topk`` at RQ1's shape ``[16, 528155]`` f32, k=10, on random
  rows and on rows that keep a warp select's bar low (all zeros, integers
  in [0, 50), all -inf but 0.1 %, ascending);
- ``streaming_dense_topk`` at D2 (``[528155, 64]`` shared by 16 queries,
  k=10), D3 (``[16, 6848, 64]`` gathered, 10 % NEG bases, k=10), D1
  (``[16, 200, 64]``, k=10) and G1 (``[16, 1000, 64]``, k=8);
- ``streaming_pq_topk`` at D4 (``[16, 6888, 16]`` uint8 codes, tables
  ``[16, 16, 256]``, contiguous and laid out ``[m, nq, n_codes]`` in memory
  as the ADC einsum leaves them, 10 % NEG bases, k=80);

each held against its plain version first.  Before those, each process
times its first call the way ``chip_smoke.time_ms`` did before it warmed
up its own steps (only the function warmed up) when its position in the
order is even, and with ``time_ms`` when it is odd, and reports that first
timing call by call: device ms, and the host's ms from the start event to
the return of ``end.record()``.  One JSON line per process; the ptxas
lines of each build that report a stack frame or spills.  Inputs are made from seed 0.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NQ, N, DIM = 16, 528155, 64
NEG = -3.0e38
EXPORTS = ("repro_topk_f32", "repro_dense_topk", "repro_pq_topk")
#: D4: candidate rows a query (8 probed lists) and PQ subspaces
D4_ROWS, D4_M = 6888, 16


def _load(tree: Path):
    """The tree's ``_build`` module, cut to the three kernels' sources and
    building apart from the tree's full library."""
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build
    _build.BUILD_ROOT = _build.BUILD_ROOT.parent / "topk_ab"
    _build.sources = lambda: [_build.CSRC / "topk.cu",
                              _build.CSRC / "dense_topk.cu",
                              _build.CSRC / "pq_topk.cu"]
    _build.SIGNATURES = {k: v for k, v in _build.SIGNATURES.items()
                         if k in EXPORTS}
    return _build


def first_call(fn, old: bool) -> dict:
    """The first timing call of a process, call by call."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if not old:
        sys.path.insert(0, str(ROOT))
        import chip_smoke
        return {"method": "time_ms", "mean": chip_smoke.time_ms(fn)}
    for _ in range(2):
        fn()
    dev, host = [], []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host.append(round(1e3 * (time.perf_counter() - t0), 4))
        end.synchronize()
        dev.append(round(start.elapsed_time(end), 4))
    return {"method": "fn warmed up only", "mean": sum(dev) / 10,
            "device_ms": dev, "host_ms": host}


def worker(tree: Path, old_first: bool) -> dict:
    import torch
    _build = _load(tree)
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels.dense_scoring.ops import streaming_dense_topk
    from repro_torch.kernels.dense_scoring.ref import dense_topk_ref
    from repro_torch.kernels.pq_scoring.ops import streaming_pq_topk
    from repro_torch.kernels.pq_scoring.ref import pq_topk_ref
    from repro_torch.kernels.topk.ops import streaming_topk
    from repro_torch.kernels.topk.ref import streaming_topk_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    u = torch.rand(NQ, N, device=dev, generator=g)
    rows = {"random": torch.randn(NQ, N, device=dev, generator=g),
            "zeros": torch.zeros(NQ, N, device=dev),
            "tied": torch.randint(0, 50, (NQ, N), device=dev,
                                  generator=g).float(),
            "neginf": torch.where(u < 0.999, -torch.inf, u),
            "ascending": torch.arange(N, device=dev, dtype=torch.float32)
            .expand(NQ, N).contiguous()}
    out = {"tree": str(tree)}
    random = rows["random"]
    out["first_call"] = first_call(lambda: streaming_topk(random, k=10),
                                   old_first)
    for name, s in rows.items():
        v1, i1 = streaming_topk(s, k=10)
        v2, i2 = streaming_topk_ref(s, k=10)
        assert torch.equal(v1, v2) and torch.equal(i1, i2), name
        out[f"topk {name}"] = [chip_smoke.time_ms(
            lambda s=s: streaming_topk(s, k=10)) for _ in range(2)]
    qv = torch.randn(NQ, DIM, device=dev, generator=g)

    def gathered(c, p_neg):
        e = torch.randn(NQ, c, DIM, device=dev, generator=g)
        b = torch.where(torch.rand(NQ, c, device=dev, generator=g) < p_neg,
                        NEG, torch.randn(NQ, c, device=dev, generator=g))
        return e, b

    shapes = {"D2": (torch.randn(N, DIM, device=dev, generator=g), None, 10),
              "D3": (*gathered(6848, 0.1), 10),
              "D1": (*gathered(200, 0.0), 10),
              "G1": (*gathered(1000, 0.0), 8)}
    for name, (e, b, k) in shapes.items():
        v1, _ = streaming_dense_topk(e, qv, b, k=k)
        v2, _ = dense_topk_ref(e, qv, b, k=k)
        torch.testing.assert_close(v1, v2, rtol=1e-5, atol=1e-5)
        out[f"dense_topk {name}"] = [chip_smoke.time_ms(
            lambda e=e, b=b, k=k: streaming_dense_topk(e, qv, b, k=k))
            for _ in range(2)]
    codes = torch.randint(0, 256, (NQ, D4_ROWS, D4_M), device=dev,
                          generator=g, dtype=torch.uint8)
    table = torch.randn(NQ, D4_M, 256, device=dev, generator=g)
    base = torch.where(torch.rand(NQ, D4_ROWS, device=dev, generator=g) < 0.1,
                       NEG, torch.randn(NQ, D4_ROWS, device=dev, generator=g))
    v1, i1 = streaming_pq_topk(codes, table, base, k=80)
    v2, i2 = pq_topk_ref(codes, table, base, k=80)
    assert torch.equal(v1, v2) and torch.equal(i1, i2), "pq_topk D4"
    out["pq_topk D4"] = [chip_smoke.time_ms(
        lambda: streaming_pq_topk(codes, table, base, k=80))
        for _ in range(2)]
    # the table laid out [m, nq, n_codes], as the ADC einsum leaves it
    strided = table.transpose(0, 1).contiguous().transpose(0, 1)
    out["pq_topk D4, einsum's table"] = [chip_smoke.time_ms(
        lambda: streaming_pq_topk(codes, strided, base, k=80))
        for _ in range(2)]
    frame = re.compile(r"\s*(\d+) bytes stack frame, (\d+) bytes spill "
                       r"stores, (\d+) bytes spill loads")
    out["frames"] = [ln.strip() for ln in _build.build_log().splitlines()
                     if (m := frame.match(ln)) and any(map(int, m.groups()))]
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--build"]:
        _load(Path(argv[1])).build()
        return 0
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker(Path(argv[1]), argv[2] == "old")),
              flush=True)
        return 0
    order = None
    if "--order" in argv:
        i = argv.index("--order")
        order = [int(x) for x in argv[i + 1].split(",")]
        argv = argv[:i] + argv[i + 2:]
    trees = [Path(t).resolve() for t in argv]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    order = order if order is not None else list(range(len(trees)))
    me = str(Path(__file__).resolve())
    builds = [subprocess.Popen([sys.executable, me, "--build", str(t)])
              for t in trees]
    if any(p.wait() != 0 for p in builds):
        return 1
    for pos, i in enumerate(order):
        rc = subprocess.call([sys.executable, me, "--worker", str(trees[i]),
                              "old" if pos % 2 == 0 else "new"])
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
