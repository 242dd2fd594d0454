"""Dry run of the paper's own workload: the fat-postings retrieval step
(multi-model scoring of gathered postings, a dense per-query accumulator,
the top-K) at ClueWeb09-scale descriptors, built on the ``meta`` device
and priced by the op counter per card of the production meshes (the port
of ``src/repro/launch/pipeline_dryrun.py``, which lowers it onto the TPU
production meshes), or on one card.

    PYTHONPATH=src python -m repro_torch.launch.pipeline_dryrun
        [--multi-pod | --one-card] [--out build/dryrun]

On a mesh (16x16, or 2x16x16 with ``--multi-pod``) the queries split over
``("pod", "data")`` and the postings over ``model`` as a doc-partitioned
inverted file: shard *m* of the postings axis holds the postings of the
documents in range *m* (``ceil(N_DOCS / model)`` documents a range).  Each
card scatters its postings into its own range's accumulator, takes a
local top-K, and only the K candidates of each card (ids, scores,
features) cross cards, by an all-gather over ``model``; a last top-K over
them resolves ties to the lowest global id.  One card cannot hold the
step (each gathered int32 array is 274.9 GB, the dense accumulator 308.6
GB): its record says so with ``fits: false``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch import collectives
from repro_torch.analysis import op_cost
from repro_torch.common import topk
from repro_torch.index import scoring
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import OUT_DIR

# ClueWeb09-scale descriptors (never materialised: meta tensors only)
N_DOCS = 50_220_423
MAXQ = 32
MAX_POSTINGS = 4_194_304      # longest non-stop posting list (padded)
N_QUERIES = 512
K = 1000
MODELS = ("BM25", "QL", "TF_IDF")
STATS = {"n_docs": float(N_DOCS), "avg_doclen": 800.0, "total_terms": 4.0e10}


def doc_range(mesh) -> tuple[int, int]:
    """(first document, documents a range) of this card's range of the
    doc-partitioned file: ``ceil(N_DOCS / model)`` documents a range, so
    the last range ends in rows past ``N_DOCS``, which hold no document."""
    per = -(-N_DOCS // mesh.shape["model"])
    return mesh.coords["model"] * per, per


def make_fat_pipeline_step(mesh=None):
    """The step on one card (``mesh=None``: every query, every posting) or
    on one card of ``mesh`` (its queries and its range's postings)."""
    def fat_pipeline_step(doc_ids, tfs, mask, dl, df, cf, weights):
        """One fused fat-retrieval step for a batch of queries.

        doc_ids/tfs/mask/dl: [NQ, MAXQ, P] gathered postings; df/cf/weights
        [NQ, MAXQ].  Each query's postings scatter their F model scores
        into a dense [docs, F] accumulator (on a mesh, this card's range);
        the first model's top-K and the other models' features at those
        documents come out (on a mesh, gathered over ``model`` and cut to
        the top-K again).  This is the compiled form of
        ``Retrieve(BM25) >> (Extract ** Extract)`` after the fat rewrite.
        """
        F = len(MODELS)
        lo, n_rows = (0, N_DOCS) if mesh is None else doc_range(mesh)
        all_s = scoring.score_all(list(MODELS), tfs, dl, df[..., None],
                                  cf[..., None], STATS)
        all_s = all_s * (weights[..., None] * mask)[..., None]
        NQ = doc_ids.shape[0]
        flat_docs = doc_ids.reshape(NQ, -1)
        flat_s = all_s.reshape(NQ, -1, F)
        dense = torch.zeros((NQ, n_rows, F), dtype=torch.float32,
                            device=doc_ids.device)
        for q in range(NQ):
            dense[q].index_add_(0, flat_docs[q] - lo if lo else flat_docs[q],
                                flat_s[q])
        n_valid = min(n_rows, N_DOCS - lo)
        if n_valid < n_rows:
            # the rows past the last document never reach the top-K
            dense[:, n_valid:, 0] = -torch.inf
        top_s, top_d = topk(dense[..., 0], K)
        feats = dense[..., 1:].gather(1, top_d[..., None].expand(-1, -1, F - 1))
        top_d = top_d.to(torch.int32)
        if mesh is None:
            return top_d, top_s, feats
        # only each card's K candidates cross cards; the ranges are in
        # ascending order, so the merge's ties go to the lowest global id
        ids = collectives.all_gather(top_d + lo, mesh, "model", dim=1)
        vals = collectives.all_gather(top_s, mesh, "model", dim=1)
        cand = collectives.all_gather(feats, mesh, "model", dim=1)
        top_s, sel = topk(vals, K)
        return (ids.gather(1, sel), top_s,
                cand.gather(1, sel[..., None].expand(-1, -1, F - 1)))
    return fat_pipeline_step


def local_shapes(mesh=None) -> tuple[tuple, tuple]:
    """(postings shape, per-query shape) of one card's arguments."""
    if mesh is None:
        return (N_QUERIES, MAXQ, MAX_POSTINGS), (N_QUERIES, MAXQ)
    dp = mesh.size // mesh.shape["model"]
    nq = N_QUERIES // dp
    return (nq, MAXQ, MAX_POSTINGS // mesh.shape["model"]), (nq, MAXQ)


def run(mesh=None) -> dict:
    """Build one card's inputs on ``meta`` and price the step there; the
    record (``mesh=None``: one card; else a card of the shape-only
    ``mesh``, at its coordinates)."""
    shp3, shp2 = local_shapes(mesh)
    args = [torch.empty(s, dtype=d, device="meta") for s, d in (
        (shp3, torch.int32),     # doc_ids
        (shp3, torch.int32),     # tfs
        (shp3, torch.bool),      # mask
        (shp3, torch.int32),     # dl (per posting)
        (shp2, torch.int32),     # df
        (shp2, torch.int32),     # cf
        (shp2, torch.float32),   # weights
    )]
    walk = op_cost.analyze(make_fat_pipeline_step(mesh), *args)
    mem = walk["memory"]
    rec = {
        "workload": "fat_pipeline_step (ClueWeb09-scale descriptors)",
        "mesh": "1 card" if mesh is None else mesh.name,
        "n_chips": 1 if mesh is None else mesh.size, "card": mesh_lib.CARD,
        "flops_per_chip": walk["flops_per_chip"],
        "bytes_per_chip": walk["bytes_per_chip"],
        "collective_bytes_per_chip": walk["collective_bytes_per_chip"],
        "collectives": walk["collectives"],
        "collective_counts": walk["collective_counts"],
        "temp_bytes": mem["temp_bytes"],
        "memory": {k: mem[k] for k in ("argument_bytes", "output_bytes",
                                       "temp_bytes", "alias_bytes")},
        "bytes_per_device": mem["peak_bytes"],
        "memory_bytes": mesh_lib.memory_bytes(),
        "t_compute": walk["flops_per_chip"] / mesh_lib.PEAK_FLOPS_FP32,
        "t_memory": walk["bytes_per_chip"] / mesh_lib.HBM_BW,
        "t_collective": (walk["collective_bytes_per_chip"] /
                         mesh_lib.NVLINK_BW),
    }
    rec["fits"] = rec["bytes_per_device"] <= rec["memory_bytes"]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--multi-pod", action="store_true")
    g.add_argument("--one-card", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    mesh = None if args.one_card else mesh_lib.make_production_mesh(
        multi_pod=args.multi_pod)
    rec = run(mesh)
    tag = "ir_pipeline__" + ("1card" if mesh is None else rec["mesh"])
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
