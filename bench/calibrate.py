"""Read the numbers of a cell's check over many seeds, for the program and
for its control (the reference in the precision below the configuration's
put in the program's place), from which the check's limits are set:

    python bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 2

One process runs every seed in turn (each a fresh collection and program);
one JSON line a seed goes to standard output."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    import harness
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        harness.log("[calibrate] no CUDA card")
        return 2
    cell = harness.Cell.load(args.workload)
    harness.log(f"[calibrate] {cell.name}; card {harness.smi()}")
    for s in args.seeds.split(","):
        t = time.perf_counter()
        out = harness.run(cell, int(s), args.seconds, False, "cuda", t,
                          control=True)
        print(json.dumps({"seed": int(s), "correct": out["correct"],
                          "metrics": out["metrics"],
                          "program": {k: v["value"] for k, v in
                                      out["checks"].items()},
                          "control": {k: v["value"] for k, v in
                                      out["control_checks"].items()}}),
              flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
