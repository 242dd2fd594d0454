"""The fat-postings step per card (``launch/pipeline_dryrun.py``) against
the JAX package.

At a small size (1,003 documents, 4 query terms, 64 posting slots, 8
queries, K 10) four gloo ranks run the port's step per card on a 2x2
``("data", "model")`` mesh over a doc-partitioned file drawn from a seed
(slot block *m* holds postings of the documents in range *m*): each
rank's gathered ids, scores and features equal the reference's
``make_fat_pipeline_step`` on the same global arrays (a 1x1 mesh, in a
process of its own) and, bit for bit, the port's one-card step.  The
ClueWeb09-scale records on the 16x16 and 2x16x16 production meshes carry
the reference's keys, an all-gather of each card's K candidates, and fit
a card.  The processes are ``tests/torch_query_mesh_worker.py``'s."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_query_mesh_worker as W
from repro_torch.launch import pipeline_dryrun as PD
from torch_parity import assert_ranking_parity

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
#: the keys of the reference's record (src/repro/launch/pipeline_dryrun.py)
REF_KEYS = {"workload", "mesh", "flops_per_chip", "bytes_per_chip",
            "collective_bytes_per_chip", "collectives", "temp_bytes",
            "t_compute", "t_memory", "t_collective"}


def _inputs(seed: int = 0) -> dict:
    """Global step inputs with a doc-partitioned postings axis: slot block
    m of the 64 holds doc ids of range m (ranges of ceil(N / 2) docs, as
    ``doc_range`` cuts them), masked slots included."""
    rng = np.random.default_rng(seed)
    s = W.FAT_SHAPE
    n_docs, model = W.FAT["N_DOCS"], s["mesh"][1]
    per = -(-n_docs // model)
    shp = (s["nq"], s["maxq"], s["p"])
    block = s["p"] // model
    doc_ids = np.empty(shp, np.int32)
    for m in range(model):
        hi = min(n_docs, (m + 1) * per)
        doc_ids[..., m * block:(m + 1) * block] = rng.integers(
            m * per, hi, shp[:2] + (block,))
    doc_len = rng.integers(50, 1500, n_docs).astype(np.int32)
    return {"doc_ids": doc_ids,
            "tfs": rng.integers(1, 6, shp).astype(np.int32),
            "mask": rng.random(shp) < 0.8,
            "dl": doc_len[doc_ids],
            "df": rng.integers(1, 400, shp[:2]).astype(np.int32),
            "cf": rng.integers(400, 4000, shp[:2]).astype(np.int32),
            "weights": rng.uniform(0.5, 2.0, shp[:2]).astype(np.float32)}


@pytest.fixture(scope="module")
def fat(tmp_path_factory):
    d = tmp_path_factory.mktemp("fat")
    np.savez(d / "inputs.npz", **_inputs())
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    worker = str(Path(__file__).with_name("torch_query_mesh_worker.py"))
    cmds = [[worker, "fat_rank", str(d), str(r), str(WORLD)]
            for r in range(WORLD)] + [[worker, "fat_reference", str(d)]]
    procs = [subprocess.Popen([sys.executable, *c], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out))
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    return {"ranks": [dict(np.load(d / f"rank{r}.npz"))
                      for r in range(WORLD)],
            "ref": dict(np.load(d / "reference.npz"))}


@pytest.mark.parametrize("rank", range(WORLD))
def test_fat_step_per_card_equals_reference(fat, rank):
    """A rank's queries after the all-gather over ``model`` and the final
    top-K: ids and scores equal the reference's (scores within rtol 2e-5,
    ids equal but inside a tie), features alike; bit-equal to the port's
    one-card step over the whole file."""
    r, ref = fat["ranks"][rank], fat["ref"]
    rows = r["rows"]
    assert r["ids"].shape == (len(rows), W.FAT["K"])
    np.testing.assert_array_equal(r["ids"], r["one_ids"])
    for k in ("scores", "feats"):
        np.testing.assert_array_equal(r[k].view(np.uint32),
                                      r[f"one_{k}"].view(np.uint32))
    assert_ranking_parity(ref["ids"][rows], ref["scores"][rows], r["ids"],
                          r["scores"], what=f"rank {rank}")
    same = ref["ids"][rows] == r["ids"]
    np.testing.assert_allclose(r["feats"][same], ref["feats"][rows][same],
                               rtol=2e-5, atol=1e-5)
    # the ranks of one model shard saw other doc ranges, and every id is a
    # document (the last range's pad row never reaches the top-K)
    assert ((r["ids"] >= 0) & (r["ids"] < W.FAT["N_DOCS"])).all()


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_dryrun_record_per_card(tmp_path, multi_pod):
    """The ClueWeb09-scale step per card of the production meshes: the
    reference's keys and the port's, 256 / 512 cards, one all-gather a
    tensor of each card's K candidates over ``model``, and it fits a card
    (one card's record: ``fits`` false)."""
    rec = PD.main(["--out", str(tmp_path)] +
                  (["--multi-pod"] if multi_pod else []))
    name = "2x16x16" if multi_pod else "16x16"
    assert json.loads((tmp_path / f"ir_pipeline__{name}.json").read_text()) \
        == json.loads(json.dumps(rec))
    assert REF_KEYS <= set(rec)
    assert rec["mesh"] == name and rec["n_chips"] == (512 if multi_pod
                                                      else 256)
    nq = PD.N_QUERIES // (32 if multi_pod else 16)
    F = len(PD.MODELS)
    gathered = nq * 16 * PD.K * (4 + 4 + 4 * (F - 1))
    assert rec["collectives"] == {"all-gather": float(gathered)}
    assert rec["collective_counts"] == {"all-gather": 3.0}
    assert rec["t_collective"] == gathered / 450e9
    assert rec["fits"] is True
    assert rec["bytes_per_device"] < 80e9 and rec["flops_per_chip"] > 0
    assert rec["memory"]["argument_bytes"] == \
        nq * PD.MAXQ * (PD.MAX_POSTINGS // 16) * 13 + nq * PD.MAXQ * 12
