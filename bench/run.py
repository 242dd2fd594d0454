"""Run one cell of the benchmark once, from the root of a checkout:

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints what it does on standard error (the card and its power limit, the
set-up's parts, the window, the numbers of the check beside their
limits) and, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``.  Exits non-zero, printing no result, without enough CUDA
cards, when a run fails, or when JAX or the JAX package was loaded."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    import harness
    # one process, few threads: the host's torch operations run on one
    # thread, so its thread pool adds no noise to the window
    torch.set_num_threads(1)
    cell = harness.Cell.load(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"[bench] the cell needs {chips} CUDA card(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                    f"found")
        return 2
    harness.log(f"[bench] {cell.name} seed {args.seed} seconds {args.seconds} "
                f"trace {args.trace}; card {harness.smi()}; torch "
                f"{torch.__version__} CUDA {torch.version.cuda}")
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"[bench] refused: modules loaded: {bad}")
        return 3
    for k, v in out["checks"].items():
        harness.log(f"[check] {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
