"""Dry run of the paper's own workload on one card: the fat-postings
retrieval step (multi-model scoring of gathered postings, a dense
per-query accumulator, the top-K) at ClueWeb09-scale descriptors, built
on the ``meta`` device and priced by the op counter (the port of
``src/repro/launch/pipeline_dryrun.py``, which lowers it onto the TPU
production meshes).

    PYTHONPATH=src python -m repro_torch.launch.pipeline_dryrun
        [--out build/dryrun]

Nothing is cut: one card cannot hold the step (each gathered int32 array
is 274.9 GB, the dense accumulator 308.6 GB), and the record says so with
``fits: false``.  Sharding it over cards waits for the multi-card slice.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

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


def make_fat_pipeline_step():
    def fat_pipeline_step(doc_ids, tfs, mask, dl, df, cf, weights):
        """One fused fat-retrieval step for a batch of queries.

        doc_ids/tfs/mask/dl: [NQ, MAXQ, P] gathered postings; df/cf/weights
        [NQ, MAXQ].  Each query's postings scatter their F model scores
        into a dense [N_DOCS, F] accumulator; the first model's top-K and
        the other models' features at those documents come out.  This is
        the compiled form of ``Retrieve(BM25) >> (Extract ** Extract)``
        after the fat rewrite.
        """
        all_s = scoring.score_all(list(MODELS), tfs, dl, df[..., None],
                                  cf[..., None], STATS)
        all_s = all_s * (weights[..., None] * mask)[..., None]
        NQ = doc_ids.shape[0]
        flat_docs = doc_ids.reshape(NQ, -1)
        flat_s = all_s.reshape(NQ, -1, len(MODELS))
        dense = torch.zeros((NQ, N_DOCS, len(MODELS)), dtype=torch.float32,
                            device=doc_ids.device)
        for q in range(NQ):
            dense[q].index_add_(0, flat_docs[q], flat_s[q])
        top_s, top_d = topk(dense[..., 0], K)
        feats = dense[..., 1:].gather(
            1, top_d[..., None].expand(-1, -1, len(MODELS) - 1))
        return top_d.to(torch.int32), top_s, feats
    return fat_pipeline_step


def run() -> dict:
    """Build the step's inputs on ``meta`` and price it; the record."""
    shp3 = (N_QUERIES, MAXQ, MAX_POSTINGS)
    shp2 = (N_QUERIES, MAXQ)
    args = [torch.empty(s, dtype=d, device="meta") for s, d in (
        (shp3, torch.int32),     # doc_ids
        (shp3, torch.int32),     # tfs
        (shp3, torch.bool),      # mask
        (shp3, torch.int32),     # dl (per posting)
        (shp2, torch.int32),     # df
        (shp2, torch.int32),     # cf
        (shp2, torch.float32),   # weights
    )]
    walk = op_cost.analyze(make_fat_pipeline_step(), *args)
    mem = walk["memory"]
    rec = {
        "workload": "fat_pipeline_step (ClueWeb09-scale descriptors)",
        "mesh": "1 card", "n_chips": 1, "card": mesh_lib.CARD,
        "flops_per_chip": walk["flops_per_chip"],
        "bytes_per_chip": walk["bytes_per_chip"],
        "collective_bytes_per_chip": 0.0,
        "collectives": {},
        "temp_bytes": mem["temp_bytes"],
        "memory": {k: mem[k] for k in ("argument_bytes", "output_bytes",
                                       "temp_bytes", "alias_bytes")},
        "bytes_per_device": mem["peak_bytes"],
        "memory_bytes": mesh_lib.memory_bytes(),
        "t_compute": walk["flops_per_chip"] / mesh_lib.PEAK_FLOPS_FP32,
        "t_memory": walk["bytes_per_chip"] / mesh_lib.HBM_BW,
        "t_collective": 0.0,
    }
    rec["fits"] = rec["bytes_per_device"] <= rec["memory_bytes"]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    rec = run()
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "ir_pipeline__1card.json").write_text(
        json.dumps(rec, indent=1))
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
