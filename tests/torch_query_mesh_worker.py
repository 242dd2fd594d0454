"""The processes of ``tests/test_torch_query_mesh.py`` and
``tests/test_torch_pipeline_dryrun_mesh.py``.

    python tests/torch_query_mesh_worker.py engine <out_dir>
    python tests/torch_query_mesh_worker.py fat_rank <dir> <rank> <world>
    python tests/torch_query_mesh_worker.py fat_reference <dir>

``engine``: the reference on four forced host devices.  Its
``make_query_mesh`` for every (max_devices, doc_shards) case of
``MESH_CASES`` (axis names, shape, device ids, or the error), and the
``REF_PIPELINES`` of ``tests/test_torch_engine.py::_pipelines`` through a
``JaxBackend`` on its sharded engine over a ``("data",)`` mesh of the four
devices (Auto axes) at every query count of ``NQS``; writes
``<out_dir>/engine.json`` and ``<out_dir>/engine.npz``.  It must be a
process of its own: the device-count flag is read at JAX's first use.

``fat_rank``: one of ``world`` (4) gloo ranks on the CPU, on a 2x2
``("data", "model")`` card mesh: the port's fat step per card
(``launch/pipeline_dryrun.py``, its constants set to ``FAT``) on the
rank's slice of ``<dir>/inputs.npz``, and the one-card step on all of it;
writes ``<dir>/rank<r>.npz``.

``fat_reference``: the reference's ``make_fat_pipeline_step`` (constants
set to ``FAT``) jitted on a 1x1 mesh with Auto axes over the same global
arrays; writes ``<dir>/reference.npz``.  Importing the reference's module
sets ``XLA_FLAGS`` to 512 host devices, so JAX is initialised first.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: (max_devices, doc_shards) cases of the query mesh
MESH_CASES = [(m, d) for m in (None, 1, 2, 3, 4, 5, 8)
              for d in (None, 1, 2, 3, 4)]
#: query counts of the pipelines (the default ladder's edges and past it)
NQS = (1, 7, 16, 33, 50)
#: the fused top-k route and the fat route of ``_pipelines``
REF_PIPELINES = (0, 1)
#: the fat step's cut constants (the module's names) and input shapes
FAT = {"N_DOCS": 1003, "K": 10}
FAT_SHAPE = {"nq": 8, "maxq": 4, "p": 64, "mesh": (2, 2)}


def _paths():
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))


def pipelines(M):
    """``tests/test_torch_engine.py::_pipelines``, from either package."""
    R, X = M.Retrieve, M.Extract
    return [
        R("BM25") % 5,
        (R("BM25") >> (X("QL") ** X("DPH"))) % 5,
        (R("BM25", k=30) >> M.DenseRerank(alpha=0.3)) % 5,
        M.DenseRetrieve(k=5, nprobe=2) % 5,
        M.DenseRetrieve(k=5, nprobe=2, pq=True) % 5,
        R("BM25", k=20) >> M.RM3Expand(fb_terms=5, fb_docs=5)
        >> R("BM25", k=10),
    ]


def tiled(topics, nq):
    """``nq`` queries: the T topics repeated, each copy with its own qid."""
    terms = np.tile(np.asarray(topics.terms), (nq // 8 + 1, 1))[:nq]
    weights = np.tile(np.asarray(topics.weights), (nq // 8 + 1, 1))[:nq]
    return terms, weights, np.arange(nq, dtype=np.int32)


def fat_stats(n_docs: int) -> dict:
    return {"n_docs": float(n_docs), "avg_doclen": 800.0,
            "total_terms": 4.0e10}


def run_engine(out: Path) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    _paths()
    import jax
    from jax.sharding import AxisType

    import repro.core as J
    from repro.core.compiler import JaxBackend
    from repro.core.data import make_queries
    from repro.core.engine import ShardedQueryEngine
    from repro.index.inverted import build_index
    from repro.launch.mesh import make_query_mesh
    from torch_parity import small_env

    meshes = []
    for m, d in MESH_CASES:
        try:
            mesh = make_query_mesh(max_devices=m, doc_shards=d)
            meshes.append({"names": list(mesh.axis_names),
                           "shape": list(mesh.devices.shape),
                           "ids": [int(x.id) for x in mesh.devices.flat]})
        except ValueError as e:
            meshes.append({"error": str(e)})
    corpus, topics, _ = small_env()
    mesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
    be = JaxBackend(build_index(corpus), default_k=60,
                    engine=ShardedQueryEngine(mesh=mesh))
    res = {}
    for i in REF_PIPELINES:
        for nq in NQS:
            R = J.run_pipeline(pipelines(J)[i], make_queries(
                *tiled(topics, nq)), backend=be)
            for k in ("docids", "scores", "features"):
                if k in R:
                    res[f"{i}/{nq}/{k}"] = np.asarray(R[k])
    np.savez(out / "engine.npz", **res)
    (out / "engine.json").write_text(json.dumps({
        "meshes": meshes, "devices": len(jax.local_devices()),
        "engine_devices": be.engine.n_devices}))


def _fat_inputs(path: Path):
    import torch
    data = np.load(path / "inputs.npz")
    return [torch.from_numpy(data[k]) for k in
            ("doc_ids", "tfs", "mask", "dl", "df", "cf", "weights")]


def run_fat_rank(path: Path, rank: int, world: int) -> None:
    _paths()
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import pipeline_dryrun as PD

    torch.set_num_threads(1)
    for name, v in FAT.items():
        setattr(PD, name, v)
    PD.STATS = fat_stats(FAT["N_DOCS"])
    mesh_lib.init_cards(rank, world, f"file://{path / 'store'}",
                        backend="gloo")
    mesh = mesh_lib.make_card_mesh(FAT_SHAPE["mesh"], device="cpu")
    args = _fat_inputs(path)
    dp, mp = mesh.coords["data"], mesh.coords["model"]
    nq = args[0].shape[0] // mesh.shape["data"]
    p = args[0].shape[2] // mesh.shape["model"]
    rows = slice(dp * nq, (dp + 1) * nq)
    local = [a[rows, :, mp * p:(mp + 1) * p] if a.dim() == 3 else a[rows]
             for a in args]
    ids, vals, feats = PD.make_fat_pipeline_step(mesh)(*local)
    one = PD.make_fat_pipeline_step(None)(*args)
    np.savez(path / f"rank{rank}.npz", rows=np.arange(nq) + dp * nq,
             ids=ids.numpy(), scores=vals.numpy(), feats=feats.numpy(),
             one_ids=one[0][rows].numpy(), one_scores=one[1][rows].numpy(),
             one_feats=one[2][rows].numpy(), lo=PD.doc_range(mesh)[0])


def run_fat_reference(path: Path) -> None:
    os.environ.pop("XLA_FLAGS", None)
    os.environ["JAX_PLATFORMS"] = "cpu"
    _paths()
    import jax
    from jax.sharding import AxisType
    jax.devices()                     # one host device, before the import
    import repro.launch.pipeline_dryrun as RPD
    for name, v in FAT.items():
        setattr(RPD, name, v)
    RPD.STATS = fat_stats(FAT["N_DOCS"])
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    data = np.load(path / "inputs.npz")
    args = [jax.numpy.asarray(data[k]) for k in
            ("doc_ids", "tfs", "mask", "dl", "df", "cf", "weights")]
    with mesh:
        ids, vals, feats = jax.jit(RPD.make_fat_pipeline_step(
            mesh, ("data",)))(*args)
    np.savez(path / "reference.npz", ids=np.asarray(ids),
             scores=np.asarray(vals), feats=np.asarray(feats))


if __name__ == "__main__":
    mode, where = sys.argv[1], Path(sys.argv[2])
    if mode == "engine":
        run_engine(where)
    elif mode == "fat_rank":
        run_fat_rank(where, int(sys.argv[3]), int(sys.argv[4]))
    elif mode == "fat_reference":
        run_fat_reference(where)
    else:
        raise SystemExit(f"unknown mode {mode}")
