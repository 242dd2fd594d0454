#!/usr/bin/env python3
"""Cold and warm compile seconds of the planned cells L1 and P1 for several
source trees of the port, on one card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 benchmarks/torch_compile_ab.py TREE [TREE ...] [--order 0,1,1,0]

Each TREE holds a ``src/repro_torch`` package: ``.`` for this checkout, or
a copy of another commit's (``git archive <commit> src/repro_torch | tar -x
-C TREE``).  The Robust04-scale index (528,155 documents) is built once on
the card with this checkout's package and kept as host arrays under
``build/compile_ab/``; then one process per entry of ``--order`` (indices
into the trees, default each tree once) loads it onto the card with that
tree's package and times, as ``chip_smoke.py`` does: the compile of L1's
five pipelines on a fresh backend (cold, then again warm; a process's
first cost count is timed apart), P1's plan
(``optimize=False``) and L1's first three pipelines planned on another
fresh backend.  A compile launches no kernel, so nothing is built.  One
JSON line per process.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "compile_ab"


def _save_index() -> None:
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.index.inverted import ARRAY_NAMES
    from repro_torch.index.robust04 import robust04
    index, _, _ = robust04(device="cuda")
    CACHE.mkdir(parents=True, exist_ok=True)
    np.savez(CACHE / "index.npz",
             **{n: getattr(index, n).cpu().numpy() for n in ARRAY_NAMES})
    (CACHE / "meta.json").write_text(json.dumps(
        {k: getattr(index, k) for k in ("n_docs", "vocab", "avg_doclen",
                                        "total_terms", "max_fwd_len")}))


def _worker(tree: Path) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import repro_torch as rt
    from chip_smoke import LADDER, _l1_pipelines
    with np.load(CACHE / "index.npz") as z:
        arrays = dict(z)
    index = rt.index_from_arrays(arrays, json.loads(
        (CACHE / "meta.json").read_text()), "cuda")
    torch.cuda.synchronize()

    def backend():
        return rt.TorchBackend(index, default_k=1000, bucket_ladder=LADDER,
                               device="cuda")

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {"tree": str(tree)}
    try:
        from repro_torch.analysis.op_cost import OpCounter
    except ImportError:           # a tree from before the cost-gated pass
        OpCounter = None
    if OpCounter is not None:
        # the first cost count of a process, timed apart from the
        # compiles (a dispatch mode's first op may import more of torch)
        def first_count():
            with OpCounter():
                torch.ones(1, device="cuda") + 1
        out["first_counter_s"] = timed(first_count)
    pipes = list(_l1_pipelines(rt, rt.LTRRerank(n_features=3,
                                                epochs=30)).values())
    be = backend()
    out["l1_cold_s"] = timed(lambda: [rt.compile_pipeline(p, be)
                                      for p in pipes])
    out["l1_warm_s"] = timed(lambda: [rt.compile_pipeline(p, be)
                                      for p in pipes])
    p1 = [rt.Retrieve("BM25", k=1000) >> rt.Extract(m)
          for m in ("QL", "TF_IDF", "DPH")]
    out["p1_plan_s"] = timed(lambda: rt.ExperimentPlan(p1, be,
                                                       optimize=False))
    fresh = backend()
    out["l1_three_planned_cold_s"] = timed(
        lambda: rt.ExperimentPlan(pipes[:3], fresh))
    out["card"] = torch.cuda.get_device_name(0)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        print(json.dumps(_worker(Path(sys.argv[2]))), flush=True)
        return 0
    args = sys.argv[1:]
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
        print("torch_compile_ab: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _save_index()
    print(f"[compile_ab] index built and saved in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for i in order if order is not None else range(len(trees)):
        subprocess.run([sys.executable, __file__, "--worker", str(trees[i])],
                       check=True, cwd=ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
