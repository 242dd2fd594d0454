#!/usr/bin/env python3
"""MRT of the dense cells D2 and D4 for several source trees of the port,
in turns, on one card, from one shared state.

Run from the repository root on a machine with one NVIDIA H100:

    python3 benchmarks/torch_dense_ab.py TREE [TREE ...] [--order 0,1,1,0]
                                         [--reps 12]

Each TREE holds a ``src/repro_torch`` package: ``.`` for this checkout, or
a copy of another commit's (``git archive <commit> src/repro_torch | tar -x
-C TREE``).  The Robust04-scale index (528,155 documents), its dense state
(embeddings, IVF and IVF-PQ, whose k-means runs on the host) and the T
topics are built once with this checkout's package and kept under
``build/dense_ab/``, so every process searches the same lists.  Then one
process per entry of ``--order`` (indices into the trees, default each
tree once) loads them onto the card with that tree's package and measures,
as ``chip_smoke.py``'s dense phase does (``Experiment(measure_time=True)``,
250 T topics, chunks of 16), each cell's MRT ``--reps`` times in three
rounds: unoptimised before any compile, optimised (its first Experiment
compiles: in a tree with the cost-gated pass, the gate's estimates run on
the card), and unoptimised again after.  It also times the host's enqueue
of one dense-scoring wrapper call on a small input (least of 5 loops of
2,000 calls) and counts the objects the garbage collector tracks.  One
JSON line per process, then the medians by tree.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "dense_ab"


def _save_state() -> None:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.index.inverted import ARRAY_NAMES
    from repro_torch.index.robust04 import robust04, robust04_dense
    index, forms, _ = robust04(device="cuda")
    dense, ivf, ivfpq, _ = robust04_dense(index)
    CACHE.mkdir(parents=True, exist_ok=True)
    np.savez(CACHE / "index.npz",
             **{n: getattr(index, n).cpu().numpy() for n in ARRAY_NAMES})
    (CACHE / "meta.json").write_text(json.dumps(
        {k: getattr(index, k) for k in ("n_docs", "vocab", "avg_doclen",
                                        "total_terms", "max_fwd_len")}))
    torch.save({"dense": dense, "ivf": ivf, "ivfpq": ivfpq,
                "topics": forms["T"]}, CACHE / "state.pt")


def _worker(tree: Path, reps: int) -> dict:
    import gc
    import numpy as np
    import torch
    sys.path.insert(0, str(tree / "src"))
    import repro_torch as rt
    from repro_torch.index.robust04 import NPROBE, PQ_M, PQ_REFINE
    from repro_torch.kernels.dense_scoring.ops import streaming_dense_topk
    with np.load(CACHE / "index.npz") as z:
        arrays = dict(z)
    index = rt.index_from_arrays(arrays, json.loads(
        (CACHE / "meta.json").read_text()), "cuda")
    st = torch.load(CACHE / "state.pt", map_location="cuda",
                    weights_only=False)
    topics = st["topics"]
    Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                        device="cuda")
    kw = dict(default_k=1000, bucket_ladder=(16,), device="cuda")
    cells = {
        "D2": (rt.DenseRetrieve(k=10, nprobe=0) % 10,
               rt.TorchBackend(index, st["dense"], ivf=st["ivf"], **kw)),
        "D4": (rt.DenseRetrieve(k=10, nprobe=NPROBE, pq=True) % 10,
               rt.TorchBackend(index, st["dense"], ivfpq=st["ivfpq"],
                               pq_m=PQ_M, pq_refine=PQ_REFINE, **kw))}

    def mrt(name, opt):
        pipe, be = cells[name]
        r = rt.Experiment([pipe], Q, topics.qrels, ["map"], backend=be,
                          optimize=opt, measure_time=True)
        return r["table"][0]["mrt_ms"]

    out = {"tree": str(tree)}
    for rnd, opt in (("unoptimised_before", False), ("optimised", True),
                     ("unoptimised_after", False)):
        for name in cells:
            out[f"{name} {rnd}"] = [round(mrt(name, opt), 5)
                                    for _ in range(reps)]
    emb = torch.randn(256, 64, device="cuda")
    q = torch.randn(16, 64, device="cuda")
    streaming_dense_topk(emb, q, k=10)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(2000):
            streaming_dense_topk(emb, q, k=10)
        best = min(best, (time.perf_counter() - t0) / 2000)
        torch.cuda.synchronize()
    out["wrapper_enqueue_us"] = round(best * 1e6, 3)
    out["gc_objects"] = len(gc.get_objects())
    out["card"] = torch.cuda.get_device_name(0)
    return out


def main() -> int:
    args = sys.argv[1:]
    reps = 12
    if "--reps" in args:
        i = args.index("--reps")
        reps = int(args[i + 1])
        del args[i:i + 2]
    if args[:1] == ["--worker"]:
        print(json.dumps(_worker(Path(args[1]), reps)), flush=True)
        return 0
    order = None
    if "--order" in args:
        i = args.index("--order")
        order = [int(x) for x in args[i + 1].split(",")]
        del args[i:i + 2]
    trees = [Path(t).resolve() for t in args]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("torch_dense_ab: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _save_state()
    print(f"[dense_ab] index and dense state built and saved in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    for i in order if order is not None else range(len(trees)):
        p = subprocess.run([sys.executable, __file__, "--worker",
                            str(trees[i]), "--reps", str(reps)],
                           check=True, cwd=ROOT, capture_output=True,
                           text=True)
        line = p.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for tree in trees:
        mine = [r for r in runs if r["tree"] == str(tree)]
        keys = [k for k in mine[0] if k.startswith("D")]
        med = {k: round(statistics.median(x for r in mine for x in r[k]), 5)
               for k in keys}
        print(f"[dense_ab] {tree}: median mrt_ms over {len(mine)} "
              f"process(es) x {reps} {json.dumps(med)}; wrapper enqueue us "
              f"{[r['wrapper_enqueue_us'] for r in mine]}; gc objects "
              f"{[r['gc_objects'] for r in mine]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
