"""The query engine over a mesh of cards (``make_query_mesh``, the engine's
``data`` and ``docs`` axes, the backend's replicas), on four CPU "cards"
(``devices=["cpu"] * 4``, each replica a clone of the home card's state).

The six pipelines of ``tests/test_torch_engine.py`` through a 4-card
engine are bit-equal to the one-card engine's at every query count, and
to the sequential loop's where the one-card engine is (the sparse
pipelines; the dense ones hold the engine's tolerance there, since a
matmul of one row rounds as a batch may not); the fused top-k and fat
routes equal the reference's own engine sharded over four forced host
devices, whose ``make_query_mesh`` the port's meshes equal.  The
reference runs in a process of its own
(``tests/torch_query_mesh_worker.py engine``), started with the module
and read by the last tests."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.serve as TS
import torch_query_mesh_worker as W
from repro_torch.core.compiler import TorchBackend
from repro_torch.core.data import make_queries
from repro_torch.core.engine import ShardedQueryEngine, StageProgram
from repro_torch.core.plan import backend_digest
from repro_torch.index import dense as TD
from repro_torch.index.inverted import build_index as tbuild
from repro_torch.launch.mesh import make_query_mesh
from torch_parity import assert_ranking_parity, small_env

ROOT = Path(__file__).resolve().parents[1]
CARDS = 4
#: pipelines of ``_pipelines`` whose every stage is sparse
SPARSE = (0, 1, 5)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's run on four forced host devices, started at once;
    ``wait()`` returns its meshes and results."""
    d = tmp_path_factory.mktemp("ref_engine")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).with_name(
            "torch_query_mesh_worker.py")), "engine", str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait():
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out[-4000:]
        return {**json.loads((d / "engine.json").read_text()),
                "res": dict(np.load(d / "engine.npz"))}
    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def one_thread():
    """The module's small batches on one intra-op thread: under the
    suite's parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(reference, one_thread):
    corpus, topics, _ = small_env()
    tidx = tbuild(corpus, device="cpu")
    one = TorchBackend(tidx, default_k=60, ivf_lists=16, pq_m=8,
                       device="cpu")
    state = dict(dense=one.dense, ivf=one.ivf, ivfpq=one.ivfpq)

    def port(cards=CARDS, **kw):
        eng = ShardedQueryEngine(make_query_mesh(devices=["cpu"] * cards),
                                 **kw)
        return TorchBackend(tidx, state["dense"], default_k=60,
                            ivf=state["ivf"], ivfpq=state["ivfpq"], pq_m=8,
                            engine=eng)

    seq = TorchBackend(tidx, state["dense"], default_k=60, ivf=state["ivf"],
                       ivfpq=state["ivfpq"], pq_m=8, device="cpu",
                       sharded=False, query_chunk=4)
    return {"topics": topics, "port": port, "one": one, "four": port(),
            "seq": seq, "tidx": tidx, "results": {}}


def _queries(topics, nq):
    return make_queries(*W.tiled(topics, nq), device="cpu")


def _on_four(env, i, nq):
    """Pipeline ``i`` at ``nq`` queries on the 4-card backend, run once
    for the module."""
    key = (i, nq)
    if key not in env["results"]:
        env["results"][key] = T.run_pipeline(
            W.pipelines(T)[i], _queries(env["topics"], nq),
            backend=env["four"])
    return env["results"][key]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.is_floating_point() else x


def _equal(a: dict, b: dict) -> bool:
    keys = ("docids", "scores") + (("features",) if "features" in a else ())
    return all(torch.equal(_bits(a[k]), _bits(b[k])) for k in keys)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def _ref_arith(n, m, d):
    """The reference's ``make_query_mesh`` on ``n`` local devices: the
    devices kept, then a 1-D or (data, docs) shape, or its ValueError."""
    if m is not None:
        n = max(1, min(m, n))
    if d is None:
        return [["data"], [n]]
    if d < 1 or n % d:
        return None
    return [["data", "docs"], [n // d, d]]


@pytest.mark.parametrize("n", range(1, 9))
def test_query_mesh_shapes(n):
    """Over 1-8 CPU devices the port's mesh has the reference's axis names
    and shape for every (max_devices, doc_shards), and raises where it
    does; its home card is the first."""
    for m, d in W.MESH_CASES:
        want = _ref_arith(n, m, d)
        if want is None:
            with pytest.raises(ValueError, match="must divide"):
                make_query_mesh(devices=["cpu"] * n, max_devices=m,
                                doc_shards=d)
            continue
        mesh = make_query_mesh(devices=["cpu"] * n, max_devices=m,
                               doc_shards=d)
        assert [list(mesh.axis_names), list(mesh.devices.shape)] == want
        assert mesh.devices.size == mesh.size and mesh.device == \
            torch.device("cpu") and not mesh.live


def test_engine_over_the_mesh(env):
    """The engine's data axis, home card, ladder and stats; a rung that
    is not a multiple of the cards raises as the reference's does; a
    device is the one-card mesh."""
    eng = env["four"].engine
    assert eng.n_devices == CARDS and eng.ladder == (8, 16, 32)
    assert eng.device == torch.device("cpu") == env["four"].device
    assert eng.stats()["devices"] == CARDS
    assert eng.stats()["cards"] == ["cpu"] * CARDS
    with pytest.raises(ValueError, match="not divisible by device count"):
        ShardedQueryEngine(make_query_mesh(devices=["cpu"] * 4),
                           ladder=(2, 8))
    two_d = ShardedQueryEngine(make_query_mesh(devices=["cpu"] * 4,
                                               doc_shards=2))
    assert two_d.n_devices == 2 and two_d.ladder == (8, 16, 32)
    assert ShardedQueryEngine("cpu").n_devices == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedQueryEngine(max_devices=2)
    with pytest.raises(ValueError, match="home card"):
        TorchBackend(env["tidx"], engine=eng, device="meta")


# ---------------------------------------------------------------------------
# pipelines through four cards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq", W.NQS)
@pytest.mark.parametrize("i", range(6))
def test_four_cards_equal_one_card_and_sequential(env, i, nq):
    Q = _queries(env["topics"], nq)
    got = _on_four(env, i, nq)
    one = T.run_pipeline(W.pipelines(T)[i], Q, backend=env["one"])
    seq = T.run_pipeline(W.pipelines(T)[i], Q, backend=env["seq"])
    what = f"pipeline {i} nq {nq}"
    assert got["docids"].shape[0] == nq
    assert _equal(got, one), what
    if i in SPARSE:
        assert _equal(got, seq), what
    else:
        assert_ranking_parity(seq["docids"].numpy(), seq["scores"].numpy(),
                              got["docids"].numpy(), got["scores"].numpy(),
                              what=what + " (vs sequential)")


def test_shard_i_reads_replica_i(env):
    """Card i's shard of every chunk is handed replica i; the replicas of
    cards 1-3 are clones of the home card's state, made at first use, and
    card 0's is the backend's own."""
    be = env["port"]()
    seen = []

    def fn(rep, terms, weights):
        seen.append(rep)
        return weights.sum(1) + rep.index.doc_len[:1].float()

    Q = _queries(env["topics"], 40)              # chunks of 32 and 8
    out = be.map_query_chunks(fn, Q, key=("probe",))
    torch.testing.assert_close(out, Q["weights"].sum(1)
                               + be.index.doc_len[0].float())
    reps = [be.replica(i) for i in range(CARDS)]
    assert [id(r) for r in seen] == [id(r) for r in reps] * 2
    assert reps[0].index is be.index
    for r in reps[1:]:
        for name, a in be.index.arrays().items():
            b = getattr(r.index, name)
            assert b is not a and b.data_ptr() != a.data_ptr()
            assert torch.equal(a, b), name
    assert reps[2].dense.emb.data_ptr() != be.dense.emb.data_ptr()
    assert reps[3].ivf.centroids.data_ptr() != be.ivf.centroids.data_ptr()
    assert reps[1].qproj is reps[1].qproj


def test_compiles_bounded_and_chunk_cache_hits(env):
    """Entries count once a (key, bucket, signature) whatever the cards;
    a stage handoff reuses each card's pieces."""
    be = env["port"]()
    eng = be.engine
    for nq in (1, 3, 8, 9, 17, 33, 40, 65):
        T.run_pipeline(T.Retrieve("BM25", k=10), _queries(env["topics"], nq),
                       backend=be, optimize=False)
    assert eng.max_compiles_per_stage() <= len(eng.ladder)
    assert eng.total_compiles() == len(eng.ladder)
    hits = eng.n_chunk_cache_hits
    pipe = T.Retrieve("BM25", k=20) >> T.Extract("QL") >> T.Extract("TF_IDF")
    T.run_pipeline(pipe, _queries(env["topics"], 8), backend=be,
                   optimize=False)
    assert eng.n_chunk_cache_hits > hits
    assert eng.max_compiles_per_stage() <= len(eng.ladder)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_doc_sharded_on_a_2x2_mesh(env, n_shards):
    """D2's store in 1, 2 or 4 contiguous shards on a ("data", "docs")
    mesh: shard j's copies on the cards of doc group j, each card's
    program bound to its copy, merged bit-equal to the unsharded search."""
    k = 10
    eng = ShardedQueryEngine(make_query_mesh(devices=["cpu"] * 4,
                                             doc_shards=2))
    dense = env["one"].dense
    qv = env["one"].embed_queries(_queries(env["topics"], 13))
    shards = TD.shard_dense_index(dense, n_shards, devices=eng.mesh.devices)
    progs = []
    for copies, off in shards:
        assert len(copies) == 2 and all(
            c.emb.data_ptr() != dense.emb.data_ptr() for c in copies)
        kk = min(k, int(copies[0].emb.shape[0]))

        def bound(i, copies=copies, off=off, kk=kk):
            def fn(q):
                d, v = TD.dense_retrieve_exact_fused(copies[i], q, k=kk)
                return d + off, v
            return fn
        progs.append(StageProgram(key=("shard", n_shards, off), fn=bound(0),
                                  bind=bound))
    docs, vals = eng.run_doc_sharded(progs, None, qv, k=k)
    od, ov = TD.dense_retrieve_exact_fused(dense, qv, k=k)
    np.testing.assert_array_equal(docs, od.numpy())
    np.testing.assert_array_equal(vals.view(np.uint32),
                                  ov.numpy().view(np.uint32))
    views = TD.shard_dense_index(dense, n_shards)
    assert [o for _, o in views] == [o for _, o in shards]


def test_server_on_four_cards(env):
    """Two tenants on one server over the 4-card engine: each served
    ranking equals run_pipeline's bit for bit, and nothing is made after
    warm-up."""
    be = env["port"]()
    pipes = {"bm25": T.Retrieve("BM25") % 10,
             "fat": (T.Retrieve("BM25") >> (T.Extract("QL") **
                                            T.Extract("DPH"))) % 10}
    server = TS.MultiPipelineServer(pipes, be, TS.ServeConfig.default())
    Q = _queries(env["topics"], 8)
    server.warmup(Q)
    rng = np.random.default_rng(0)
    for name, pipe in pipes.items():
        idx = rng.integers(0, 8, 21)
        rows = {k: v.numpy()[idx] for k, v in Q.items()}
        reqs = server.submit(rows, pipeline=name)
        server.pump()
        res = [r.wait(30) for r in reqs]
        want = T.run_pipeline(pipe, {k: torch.as_tensor(v)
                                     for k, v in rows.items()}, backend=be)
        for key in ("docids", "scores"):
            got = np.concatenate([r[key] for r in res])
            np.testing.assert_array_equal(
                _bits(torch.as_tensor(got)).numpy(),
                _bits(want[key]).numpy(), err_msg=name)
    s = server.stats()
    assert s["recompiles_since_warmup"] == 0
    assert s["engine"]["devices"] == CARDS


def test_backend_digest_does_not_count_cards(env):
    """Results are bit-equal on one card and four, so an artifact cache
    written on four cards is read on one."""
    assert backend_digest(env["port"]()) == backend_digest(
        env["port"](cards=1))


# ---------------------------------------------------------------------------
# against the reference on four forced host devices
# ---------------------------------------------------------------------------

def test_query_mesh_equals_reference(reference):
    """On four devices each (max_devices, doc_shards) case has the
    reference's axis names, shape and device order, or its error."""
    ref = reference()
    assert ref["devices"] == ref["engine_devices"] == CARDS
    cards = [f"cuda:{i}" for i in range(CARDS)]
    for (m, d), want in zip(W.MESH_CASES, ref["meshes"]):
        if "error" in want:
            with pytest.raises(ValueError) as e:
                make_query_mesh(devices=cards, max_devices=m, doc_shards=d)
            assert str(e.value) == want["error"]
            continue
        mesh = make_query_mesh(devices=cards, max_devices=m, doc_shards=d)
        assert {"names": list(mesh.axis_names),
                "shape": list(mesh.devices.shape),
                "ids": [x.index for x in mesh.devices.flat]} == want


@pytest.mark.parametrize("nq", W.NQS)
@pytest.mark.parametrize("i", W.REF_PIPELINES)
def test_four_cards_equal_reference_sharded_engine(env, reference, i, nq):
    """The fused top-k and fat routes on four cards against the
    reference's ``JaxBackend`` on its engine sharded over four devices,
    at test_torch_engine.py's tolerance."""
    res = reference()["res"]
    got = _on_four(env, i, nq)
    what = f"pipeline {i} nq {nq}"
    assert_ranking_parity(res[f"{i}/{nq}/docids"], res[f"{i}/{nq}/scores"],
                          got["docids"].numpy(), got["scores"].numpy(),
                          what=what)
    if "features" in got:
        same = res[f"{i}/{nq}/docids"] == got["docids"].numpy()
        np.testing.assert_allclose(got["features"].numpy()[same],
                                   res[f"{i}/{nq}/features"][same],
                                   rtol=2e-5, atol=1e-5, err_msg=what)
