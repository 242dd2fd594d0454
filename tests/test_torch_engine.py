"""The port's query engine (``core/engine.py``) and its use by the backend
against the JAX package, on the tests/conftest.py corpus.

The ladder policy (``default_bucket_ladder``, ``chunk_plan``,
``select_ladder_bucket``) and the cross-shard merge are held equal to the
reference's functions.  Pipelines run three ways: through the port's engine
(the default), through the port's sequential loop, and through the JAX
package's sequential backend.  Sparse stages must be bit-equal between the
engine and the sequential loop at every query count (each query's result
depends only on its own row); the dense stages, whose matmuls may round
differently with the batch size, are held there at rtol 2e-5 / atol 1e-5,
docids equal except inside a score tie, as against the reference."""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.common import select_ladder_bucket as j_select
from repro.core.compiler import JaxBackend
from repro.core.data import make_queries as j_make_queries
from repro.core.engine import ShardedQueryEngine as JEngine
from repro.core.engine import default_bucket_ladder as j_ladder
from repro.core.engine import merge_shard_topk as j_merge
from repro.index import dense as JD
from repro.index.inverted import build_index as jbuild
from repro_torch.common import select_ladder_bucket
from repro_torch.core.compiler import TorchBackend
from repro_torch.core.data import make_queries
from repro_torch.core.engine import (ShardedQueryEngine, StageProgram,
                                     default_bucket_ladder, merge_shard_topk)
from repro_torch.index import dense as TD
from repro_torch.index.inverted import build_index as tbuild

from torch_parity import assert_ranking_parity, small_env

LADDERS = [(8, 16, 32), (2, 6), (4, 8), (1,), (16,), (3, 5, 12)]
#: the bucket boundaries of the default ladder, and past its largest rung
NQS = [1, 7, 8, 9, 16, 17, 32, 33, 50]
N_LISTS = 16


# ---------------------------------------------------------------------------
# the ladder policy and the merge, against the reference's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 3, 5, 8])
def test_default_ladder_equals_reference(n_devices):
    assert default_bucket_ladder(n_devices) == j_ladder(n_devices)
    assert default_bucket_ladder(n_devices, base=4, steps=(1, 3)) == \
        j_ladder(n_devices, base=4, steps=(1, 3))
    assert ShardedQueryEngine("cpu").ladder == (8, 16, 32)


@pytest.mark.parametrize("ladder", LADDERS, ids=str)
def test_chunk_plan_and_select_bucket_equal_reference(ladder):
    eng, ref = ShardedQueryEngine("cpu", ladder=ladder), JEngine(ladder=ladder)
    assert eng.ladder == ref.ladder
    for nq in range(1, 101):
        assert eng.chunk_plan(nq) == ref.chunk_plan(nq), nq
        assert select_ladder_bucket(ladder, nq, clamp=True) == \
            j_select(ladder, nq, clamp=True)
        if nq <= ladder[-1]:
            assert eng.select_bucket(nq) == ref.select_bucket(nq)
        else:
            for fn in (eng.select_bucket, ref.select_bucket):
                with pytest.raises(ValueError, match="exceeds largest"):
                    fn(nq)
    for fn in (eng.chunk_plan, ref.chunk_plan, eng.select_bucket):
        with pytest.raises(ValueError, match="empty query batch"):
            fn(0)


@pytest.mark.parametrize("seed", range(4))
def test_merge_shard_topk_equals_reference(seed):
    rng = np.random.default_rng(seed)
    parts = []
    for s in range(3):
        # few distinct values: ties across and within shards
        vals = np.sort(rng.integers(0, 4, (5, 6)).astype(np.float32),
                       axis=1)[:, ::-1].copy()
        vals[:, -1] = -np.inf
        docs = (100 * s + np.arange(6))[None, :].repeat(5, 0).astype(np.int32)
        docs[:, -1] = -1
        parts.append((docs, vals))
    want = j_merge(parts, k=7)
    got = merge_shard_topk([(torch.as_tensor(d), torch.as_tensor(v))
                            for d, v in parts], k=7)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError, match="merge width"):
        merge_shard_topk(parts, k=19)


# ---------------------------------------------------------------------------
# pipelines through the engine
# ---------------------------------------------------------------------------

def _pipelines(M):
    """The five pipelines of tests/test_torch_isolation.py's probe, and RM3
    (a stage that reads R), from either package's stage module."""
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


#: pipelines whose every stage is sparse (bit-equal under the engine)
SPARSE = (0, 1, 5)


@pytest.fixture(scope="module")
def env():
    corpus, topics, _ = small_env()
    jidx = jbuild(corpus)
    jbe0 = JaxBackend(jidx, default_k=60, query_chunk=4, sharded=False)
    jivf = JD.build_ivf_index(jbe0.dense, n_lists=N_LISTS, seed=0)
    jpq = JD.build_ivfpq_index(jbe0.dense, n_lists=N_LISTS, seed=0, m=8)
    jbe = JaxBackend(jidx, jbe0.dense, default_k=60, query_chunk=4,
                     sharded=False, ivf=jivf, ivfpq=jpq)
    tidx = tbuild(corpus, device="cpu")
    dense = TD.dense_from_arrays(np.asarray(jbe.dense.emb), "cpu")
    tivf = TD.ivf_from_arrays(
        centroids=np.asarray(jivf.centroids), doc_ids=np.asarray(jivf.doc_ids),
        list_start=np.asarray(jivf.list_start),
        emb=np.asarray(jivf.emb), device="cpu")
    tpq = TD.ivfpq_from_arrays(
        centroids=np.asarray(jpq.centroids), codes=np.asarray(jpq.codes),
        doc_ids=np.asarray(jpq.doc_ids), list_start=np.asarray(jpq.list_start),
        codebooks=np.asarray(jpq.codebook.codebooks),
        emb=None if jpq.emb is None else np.asarray(jpq.emb), device="cpu")

    def port(**kw):
        return TorchBackend(tidx, dense, default_k=60, ivf=tivf, ivfpq=tpq,
                            device="cpu", **kw)

    return {"topics": topics, "jbe": jbe, "tidx": tidx, "port": port,
            "engine": port(), "seq": port(sharded=False, query_chunk=4)}


def _tiled(topics, nq):
    """``nq`` queries: the T topics repeated, each copy with its own qid."""
    terms = np.tile(np.asarray(topics.terms), (nq // 8 + 1, 1))[:nq]
    weights = np.tile(np.asarray(topics.weights), (nq // 8 + 1, 1))[:nq]
    qids = np.arange(nq, dtype=np.int32)
    return (j_make_queries(terms, weights, qids),
            make_queries(terms, weights, qids, device="cpu"))


@pytest.mark.parametrize("nq", NQS)
@pytest.mark.parametrize("i", range(6))
def test_engine_matches_sequential_and_reference(env, i, nq):
    jQ, tQ = _tiled(env["topics"], nq)
    got = T.run_pipeline(_pipelines(T)[i], tQ, backend=env["engine"])
    seq = T.run_pipeline(_pipelines(T)[i], tQ, backend=env["seq"])
    want = J.run_pipeline(_pipelines(J)[i], jQ, backend=env["jbe"])
    assert got["docids"].shape[0] == nq
    what = f"pipeline {i} nq {nq}"
    if i in SPARSE:
        assert torch.equal(got["docids"], seq["docids"]), what
        assert torch.equal(got["scores"].view(torch.int32),
                           seq["scores"].view(torch.int32)), what
        if "features" in seq:
            assert torch.equal(got["features"], seq["features"]), what
    else:
        assert_ranking_parity(seq["docids"].numpy(), seq["scores"].numpy(),
                              got["docids"].numpy(), got["scores"].numpy(),
                              what=what + " (engine vs sequential)")
    assert_ranking_parity(np.asarray(want["docids"]),
                          np.asarray(want["scores"]), got["docids"].numpy(),
                          got["scores"].numpy(), what=what + " (vs JAX)")


def test_backend_takes_the_engine_by_default(env, monkeypatch):
    be = env["engine"]
    assert isinstance(be.engine, ShardedQueryEngine)
    assert be.engine.ladder == (8, 16, 32) and be.engine.device == be.device
    assert env["port"](bucket_ladder=(16,)).engine.ladder == (16,)
    # an explicit query_chunk is the engine's one rung, as it is the
    # sequential loop's chunk
    assert env["port"](query_chunk=4).engine.ladder == (4,)
    assert env["port"](query_chunk=4, bucket_ladder=(2, 8)).engine.ladder \
        == (2, 8)
    assert env["seq"].engine is None and env["seq"].query_chunk == 4
    monkeypatch.setenv("REPRO_ENGINE", "sequential")
    assert env["port"]().engine is None
    other = env["port"](engine=be.engine)
    assert other.engine is be.engine and other.uid != be.uid


def test_zero_padded_rows_are_harmless(env):
    """The engine pads a chunk with zero rows (terms 0, weights 0): such
    rows run through every pipeline without raising, and nothing that a
    later stage reads from them is NaN."""
    be = env["port"](bucket_ladder=(8,))
    _, tQ = _tiled(env["topics"], 3)
    zero = {k: torch.zeros_like(v) for k, v in tQ.items()}
    for i, pipe in enumerate(_pipelines(T)):
        R = T.run_pipeline(pipe, zero, backend=be)
        assert not bool(R["scores"].isnan().any()), i
        assert bool((R["docids"] >= -1).all()), i
    # the padded pieces the chunk cache hands to the next stage
    T.run_pipeline(_pipelines(T)[5], tQ, backend=be)
    for _, _, pieces in be.engine._chunk_cache.values():
        for p in pieces:
            if p.is_floating_point():
                assert not bool(p.isnan().any())


def test_compiles_per_stage_bounded_by_ladder(env):
    """Across many distinct query counts one stage makes at most
    len(ladder) cache entries, and a structurally equal stage reuses
    them."""
    be = env["port"]()
    eng = be.engine
    pipe = T.Retrieve("BM25", k=10)
    for nq in (1, 2, 3, 5, 8, 9, 13, 21, 33, 40, 64, 65):
        T.run_pipeline(pipe, _tiled(env["topics"], nq)[1], backend=be,
                       optimize=False)
    assert eng.max_compiles_per_stage() <= len(eng.ladder)
    n = eng.max_compiles_per_stage()
    T.run_pipeline(T.Retrieve("BM25", k=10), _tiled(env["topics"], 17)[1],
                   backend=be, optimize=False)
    assert eng.max_compiles_per_stage() == n
    causes = eng.compiles_by_cause()
    assert causes["cold_rung"] == 1 and causes["pinned"] == 0
    assert causes["ladder_miss"] == len(eng.ladder) - 1
    assert eng.total_compiles() == len(eng.ladder)


def test_chunk_cache_hits_on_stage_handoff(env):
    be = env["port"]()
    pipe = T.Retrieve("BM25", k=20) >> T.Extract("QL") >> T.Extract("TF_IDF")
    T.run_pipeline(pipe, _tiled(env["topics"], 8)[1], backend=be,
                   optimize=False)
    assert be.engine.n_chunk_cache_hits > 0
    assert be.engine.stats()["chunk_cache_hits"] == \
        be.engine.n_chunk_cache_hits


def test_caches_are_lru_bounded_with_cache_info(env):
    eng = ShardedQueryEngine("cpu", ladder=(2, 4), max_jit_entries=2,
                             max_chunk_entries=2)
    _, Q = _tiled(env["topics"], 4)
    for i in range(4):                            # 4 distinct stage keys
        eng.map_queries(lambda t, w, i=i: w.sum(1) + i, Q, key=("stage", i))
    info = eng.cache_info()
    assert set(info) == {"jit", "chunk"}
    assert info["jit"]["size"] <= 2
    assert info["jit"]["evictions"] >= 2
    assert info["chunk"]["size"] <= 2
    for part in info.values():
        assert {"size", "maxsize", "hits", "misses",
                "evictions"} <= set(part)
    # an evicted key is made again on next use, and counted
    n = eng.total_compiles()
    eng.map_queries(lambda t, w: w.sum(1), Q, key=("stage", 0))
    assert eng.cache_info()["jit"]["size"] <= 2
    assert eng.total_compiles() == n + 1


def test_select_bucket_and_submit_chunk(env):
    eng = ShardedQueryEngine("cpu", ladder=(4, 8))
    assert [eng.select_bucket(n) for n in (1, 4, 5, 8)] == [4, 4, 8, 8]
    _, Q = _tiled(env["topics"], 5)
    prog = StageProgram(key=("t", "sum"), fn=lambda t, w: w.sum(1))
    out = eng.submit_chunk(prog, Q)               # one padded chunk @ 8
    torch.testing.assert_close(out, Q["weights"].sum(1))
    assert eng.n_dispatches == 1
    with pytest.raises(ValueError):
        eng.submit_chunk(prog, _tiled(env["topics"], 9)[1])
    with pytest.raises(ValueError):
        eng.submit_chunk(prog, Q, bucket=2)


def test_empty_query_batch_raises_on_both_paths(env):
    Q0 = make_queries(np.zeros((0, 4), np.int32), device="cpu")
    for be in (env["engine"], env["seq"]):
        with pytest.raises(ValueError, match="empty query batch"):
            T.run_pipeline(T.Retrieve("BM25", k=10), Q0, backend=be,
                           optimize=False)
    jQ0 = j_make_queries(np.zeros((0, 4), np.int32))
    with pytest.raises(ValueError, match="empty query batch"):
        J.run_pipeline(J.Retrieve("BM25", k=10), jQ0, backend=env["jbe"],
                       optimize=False)


def test_run_pinned_counts_one_entry_per_signature():
    eng = ShardedQueryEngine("cpu")
    lin = torch.nn.Linear(3, 2)
    calls = []

    def fn(m, x, scale):
        calls.append(1)
        return m(x) * scale

    prog = StageProgram(key=("pinned-test",), fn=fn)
    x4, x8 = torch.ones(4, 3), torch.ones(8, 3)
    a = eng.run_pinned(prog, lin, x4, 2.0)
    b = eng.run_pinned(prog, lin, x4 + 1, 2.0)       # same signature
    assert eng.compiles_by_cause()["pinned"] == 1
    eng.run_pinned(prog, lin, x8, 2.0)                # another shape
    eng.run_pinned(prog, lin, x4, 3.0)                # another value
    eng.run_pinned(prog, torch.nn.Linear(3, 2), x4, 2.0)  # another module
    assert eng.compiles_by_cause()["pinned"] == 4
    assert eng.total_compiles() == 4 and len(calls) == 5
    torch.testing.assert_close(a, lin(x4).detach() * 2.0)
    torch.testing.assert_close(b, lin(x4 + 1).detach() * 2.0)
    # an anonymous program runs uncached
    eng.run_pinned(StageProgram(key=None, fn=fn), lin, x4, 2.0)
    assert eng.total_compiles() == 4 and eng.n_dispatches == 6


def test_run_pinned_entry_owns_its_donated_buffers():
    """A pinned entry adopts the buffer it was first given for a donated
    argument (on the card, the captured graph's own buffer): the caller
    threads it through, and a call that donates another buffer raises
    instead of writing one caller's buffer over another's."""
    eng = ShardedQueryEngine("cpu")
    prog = StageProgram(key=("acc",), fn=lambda x, buf: buf.add_(x))
    a, b = torch.zeros(3), torch.zeros(3)
    a = eng.run_pinned(prog, torch.ones(3), a, donate_argnums=(1,))
    a = eng.run_pinned(prog, torch.full((3,), 2.0), a, donate_argnums=(1,))
    torch.testing.assert_close(a, torch.full((3,), 3.0))
    with pytest.raises(ValueError, match="key of its own"):
        eng.run_pinned(prog, torch.ones(3), b, donate_argnums=(1,))
    assert torch.equal(b, torch.zeros(3))
    # under a key of its own the other buffer is another entry
    b = eng.run_pinned(StageProgram(key=("acc", 2), fn=prog.fn),
                       torch.ones(3), b, donate_argnums=(1,))
    torch.testing.assert_close(b, torch.ones(3))
    assert eng.compiles_by_cause()["pinned"] == 2


def test_dropped_backend_is_freed_by_reference_counting(env):
    """Nothing the engine holds refers back to it (its metrics gauge and
    its chunk cache's callbacks hold the caches alone), and a timed plan
    execution leaves no cycle holding the backend, so a dropped backend
    frees its engine and program entries (on the card, captured graphs
    and their memory pools) at once, without a collection pass."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        be = env["port"]()
        pipe = T.Retrieve("BM25", k=20) >> T.Extract("QL")
        # the result's tensors keep their chunk-cache entries alive
        R = T.run_pipeline(pipe, _tiled(env["topics"], 9)[1], backend=be,
                           optimize=False)
        T.Experiment([pipe], _tiled(env["topics"], 8)[1],
                     env["topics"].qrels, ["map"], backend=be,
                     measure_time=True)
        eng = be.engine
        eng.run_pinned(StageProgram(key=("acc",), fn=lambda x: x * 2),
                       torch.ones(2))
        assert len(eng._chunk_cache) > 0 and len(eng._jit_cache) > 0
        gauge = eng.metrics.snapshot()["engine_jit_cache_entries"]
        assert gauge["series"][""] == len(eng._jit_cache)
        refs = [weakref.ref(be), weakref.ref(eng),
                weakref.ref(eng._jit_cache)]
        del be, eng
        assert [r() for r in refs] == [None, None, None]
        del R                   # its entries' callbacks find no cache
    finally:
        gc.enable()


def _shard_programs(dense, n_shards, k, shard_fn, search, offset_of):
    """One StageProgram a contiguous shard: the shard's exact top-k with
    global ids (``offset_of`` types the offset for the package)."""
    progs = []
    for shard, off in shard_fn(dense, n_shards):
        ks = min(k, int(shard.emb.shape[0]))
        progs.append((shard, off, ks))
    return [StageProgram(key=("shard", n_shards, off), fn=lambda q, sh=sh,
                         o=offset_of(off), kk=ks: (lambda dv: (
                             dv[0] + o, dv[1]))(search(sh, q, k=kk)))
            for sh, off, ks in progs]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_run_doc_sharded_waits_for_its_item(env, n_shards):
    """``run_doc_sharded`` runs one program per contiguous shard (each
    shard's exact top-k on the dense-scoring kernel's path, global ids),
    waits once for every shard's result and merges on the host: bit-equal
    to the unsharded search and to the JAX engine's single-shard oracle,
    at 1, 2 and 4 shards.  The JAX engine's own 2- and 4-shard runs agree
    as rankings only: XLA's CPU dot rounds by the shard's row count (the
    reference's tests/test_dense.py::test_doc_shard_merge_matches_single_
    shard_oracle fails on this host for 2 and 4 shards), where the port's
    per-row dot products do not depend on the other rows."""
    import jax.numpy as jnp
    from repro.core.engine import StageProgram as JProgram
    k = 10
    jdense, tdense = env["jbe"].dense, env["engine"].dense
    qv = np.asarray(env["jbe"].embed_queries(j_make_queries(
        np.asarray(env["topics"].terms), np.asarray(env["topics"].weights),
        np.asarray(env["topics"].qids))))
    docs, vals = ShardedQueryEngine("cpu").run_doc_sharded(
        _shard_programs(tdense, n_shards, k, TD.shard_dense_index,
                        TD.dense_retrieve_exact_fused, int),
        None, torch.as_tensor(qv), k=k)

    def jrun(n):
        progs = [JProgram(key=p.key, fn=p.fn) for p in _shard_programs(
            jdense, n, k, JD.shard_dense_index, JD.dense_retrieve_exact,
            jnp.int32)]
        return JEngine(ladder=(8,)).run_doc_sharded(progs, None,
                                                    jnp.asarray(qv), k=k)

    od, ov = TD.dense_retrieve_exact_fused(tdense, torch.as_tensor(qv), k=k)
    for want_d, want_v in ((od.numpy(), ov.numpy()), jrun(1)):
        np.testing.assert_array_equal(docs, np.asarray(want_d))
        np.testing.assert_array_equal(
            vals.view(np.uint32), np.asarray(want_v).view(np.uint32))
    jd, jv = jrun(n_shards)
    assert_ranking_parity(jd, jv, docs, vals, what=f"{n_shards} shards")


def test_plan_and_experiment_run_through_the_engine(env):
    """Timed plan executions (barriers at stage boundaries) and untimed
    ones return the sequential loop's results."""
    be, seq = env["engine"], env["seq"]
    _, tQ = _tiled(env["topics"], 8)
    pipes = [p for i, p in enumerate(_pipelines(T)) if i in SPARSE]
    for record in (None, "cold"):
        got = T.ExperimentPlan(pipes, be).execute(tQ, record=record)
        want = T.ExperimentPlan(pipes, seq).execute(tQ)
        for g, w in zip(got, want):
            assert torch.equal(g["docids"], w["docids"])
    res = T.Experiment(pipes, tQ, env["topics"].qrels, ["map"], backend=be,
                       measure_time=True)
    assert all(row["mrt_ms"] > 0 for row in res["table"])
