"""Dry run of every (arch x shape) cell, on one card or per card of a mesh:
each step is built on the ``meta`` device and priced by the op counter
(``analysis/op_cost.py::analyze``), so a full-width cell needs neither a
card nor a compiler (the port of ``src/repro/launch/dryrun.py``, which
lowers each cell onto the TPU production meshes and reads the compiled
HLO).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--multi-pod | --both-meshes]
        [--override key=value ...] [--tag T] [--out build/dryrun]

Without a mesh flag each cell is priced on one card (records tagged
``1card``); ``--multi-pod`` prices it per card of the reference's 2x16x16
mesh, ``--both-meshes`` of its 16x16 and of the 2x16x16 (``sp``, ``mp``):
a shape-only mesh at rank 0's coordinates, whose collectives
(``repro_torch/collectives.py``) are recorded and move nothing;
``run_cell(..., mesh=)`` prices a cell on any shape-only mesh.  On a
mesh an LM's train_4k is priced per card as its serve cells are: the
rank's parameter shards and ZeRO-1 moments, its rows of the batch, and
the backward's collectives (the gathers' reduce-scatters, the
all-reduces, the optimizer's reduce-scatter and all-gather).  Each
record keeps the reference's keys and adds ``fits``: the card's peak
bytes against the card's memory.  ``t_compute`` prices the step's
operations at the peak of its dtype (bf16 tensor cores for the LMs, fp32
for the zoo), ``t_collective`` the collective bytes over NVLink.  A
failing cell is recorded and the exit is 1.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.analysis import op_cost
from repro_torch.configs.registry import all_arch_ids, get_arch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import _apply_overrides, build_bundle

#: the checkout's build directory (listed in .gitignore)
OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool | None = None,
             mesh=None, verbose: bool = True,
             overrides: dict[str, str] | None = None) -> dict:
    """Build the cell's step on ``meta`` and price it per card: on one
    card (neither ``multi_pod`` nor ``mesh``), on a production mesh
    (``multi_pod`` False: 16x16, True: 2x16x16), or on ``mesh`` (a
    shape-only ``launch.mesh.Mesh``); returns its record."""
    if multi_pod is not None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size if mesh is not None else 1
    rec: dict = {"arch": arch_id, "shape": shape_name,
                 "mesh": mesh.name if mesh is not None else "1 card",
                 "n_chips": n_chips, "overrides": overrides or {},
                 "card": mesh_lib.CARD}
    t0 = time.time()
    bundle = build_bundle(arch_id, shape_name, device="meta", mesh=mesh,
                          overrides=overrides)
    rec["build_s"] = round(time.time() - t0, 2)
    t1 = time.time()
    walk = op_cost.analyze(bundle.fn, *bundle.args)
    rec["analyze_s"] = round(time.time() - t1, 2)
    dtype = _apply_overrides(get_arch(arch_id),
                             overrides or {}).model_cfg(shape_name).dtype
    mem = walk["memory"]
    rec["memory"] = {k: mem[k] for k in ("argument_bytes", "output_bytes",
                                         "temp_bytes", "alias_bytes")}
    rec["bytes_per_device"] = mem["peak_bytes"]
    rec["memory_bytes"] = mesh_lib.memory_bytes()
    rec["fits"] = rec["bytes_per_device"] <= rec["memory_bytes"]
    for k in ("flops_per_chip", "bytes_per_chip", "collectives",
              "collective_bytes_per_chip", "collective_counts"):
        rec[k] = walk[k]
    rec["model_flops"] = bundle.model_flops_per_step
    rec["dtype"] = str(dtype).removeprefix("torch.")
    rec["t_compute"] = rec["flops_per_chip"] / mesh_lib.peak_flops(dtype)
    rec["t_memory"] = rec["bytes_per_chip"] / mesh_lib.HBM_BW
    rec["t_collective"] = (rec["collective_bytes_per_chip"] /
                           mesh_lib.NVLINK_BW)
    terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
             "collective": rec["t_collective"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    total = rec["flops_per_chip"] * n_chips
    rec["useful_flops_ratio"] = rec["model_flops"] / total if total else 0.0
    if verbose:
        print(f"[{rec['mesh']}] {arch_id} x {shape_name}: build "
              f"{rec['build_s']}s price {rec['analyze_s']}s | flops/card "
              f"{rec['flops_per_chip']:.3g} bytes/card "
              f"{rec['bytes_per_chip']:.3g} coll/card "
              f"{rec['collective_bytes_per_chip']:.3g} | peak "
              f"{rec['bytes_per_device'] / 1e9:.2f} GB a card "
              f"({'fits' if rec['fits'] else 'does not fit'}) | t=(c "
              f"{rec['t_compute']:.2e}, m {rec['t_memory']:.2e}, x "
              f"{rec['t_collective']:.2e}) -> {rec['bottleneck']}",
              flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (e.g. attn_impl=pallas); "
                         "results tagged with --tag")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    overrides = dict(kv.split("=", 1) for kv in args.override)
    archs = [args.arch] if args.arch else all_arch_ids()
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = [False, True] if args.both_meshes else \
        [True] if args.multi_pod else [None]
    names = {None: "1card", False: "sp", True: "mp"}

    failures = []
    for arch_id in archs:
        shapes = [args.shape] if args.shape else \
            sorted(get_arch(arch_id).shapes)
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch_id}__{shape_name}__{names[mp]}"
                if args.tag:
                    tag += f"__{args.tag}"
                try:
                    rec = run_cell(arch_id, shape_name, multi_pod=mp,
                                   overrides=overrides or None)
                    (outdir / f"{tag}.json").write_text(
                        json.dumps(rec, indent=1))
                except Exception as e:  # noqa: BLE001 — record and continue
                    failures.append(tag)
                    print(f"FAILED {tag}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nDRY-RUN PASS")


if __name__ == "__main__":
    main()
