"""The port's dense second stage (``index/dense.py``, the dense rerank of
``index/retrieve.py``, the dense stages and their lowerings) against the
JAX package, on the tests/conftest.py corpus.

The JAX package's embeddings, lists and codes are carried across as numpy
arrays (``dense_from_arrays`` and friends) wherever a test compares
searches, so both sides search identical state; the builds themselves are
compared separately.  Rankings are held with ``assert_ranking_parity``
(scores within rtol 2e-5 / atol 1e-5, docids equal except inside a score
tie)."""
import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.compiler import JaxBackend
from repro.index import dense as JD
from repro.index import retrieve as JRT
from repro.index.inverted import build_index as jbuild
from repro_torch.core.compiler import TorchBackend
from repro_torch.index import dense as TD
from repro_torch.index import retrieve as TRT
from repro_torch.index.inverted import build_index as tbuild

from torch_parity import (assert_ranking_parity, jax_queries, small_env,
                          torch_queries)

DENSE_CAPS = frozenset({"fat", "fused_dense", "dense_topk", "pq_topk"})
N_LISTS = 16


@pytest.fixture(scope="module")
def env():
    corpus, topics, _ = small_env()
    jidx = jbuild(corpus)
    tidx = tbuild(corpus, device="cpu")
    jbe = JaxBackend(jidx, default_k=60, query_chunk=4, sharded=False)
    jQ, tQ = jax_queries(topics), torch_queries(topics)
    jivf = JD.build_ivf_index(jbe.dense, n_lists=N_LISTS, seed=0)
    jpq = JD.build_ivfpq_index(jbe.dense, n_lists=N_LISTS, seed=0, m=8)
    return {"corpus": corpus, "topics": topics, "jidx": jidx, "tidx": tidx,
            "jbe": jbe, "jQ": jQ, "tQ": tQ,
            "tdense": TD.dense_from_arrays(np.asarray(jbe.dense.emb), "cpu"),
            "jqv": jbe.embed_queries(jQ),
            "tqv": torch.tensor(np.asarray(jbe.embed_queries(jQ))),
            "jivf": jivf, "tivf": _ivf_across(jivf), "jpq": jpq,
            "tpq": _pq_across(jpq), "backends": {}}


def _ivf_across(jivf):
    return TD.ivf_from_arrays(
        centroids=np.asarray(jivf.centroids), doc_ids=np.asarray(jivf.doc_ids),
        list_start=np.asarray(jivf.list_start),
        emb=None if jivf.emb is None else np.asarray(jivf.emb), device="cpu")


def _pq_across(jpq):
    return TD.ivfpq_from_arrays(
        centroids=np.asarray(jpq.centroids), codes=np.asarray(jpq.codes),
        doc_ids=np.asarray(jpq.doc_ids), list_start=np.asarray(jpq.list_start),
        codebooks=np.asarray(jpq.codebook.codebooks),
        emb=None if jpq.emb is None else np.asarray(jpq.emb), device="cpu")


def _per_query(fn, state, qvecs, **kw):
    """A JAX per-query search mapped over the queries."""
    return jax.vmap(lambda qv: fn(state, qv, **kw))(qvecs)


def _agree(j, t, what):
    """(docids, scores) of both sides agree as rankings."""
    assert_ranking_parity(np.asarray(j[0]), np.asarray(j[1]),
                          t[0].numpy(), t[1].numpy(), what=what)


# ---------------------------------------------------------------------------
# builds
# ---------------------------------------------------------------------------

def test_embedding_build_matches_reference(env):
    """The forward-file projection built with torch (an entry-order sum in
    f32) against the reference's numpy build: rtol 1e-5 / atol 1e-6."""
    dense = TD.build_dense_index(env["tidx"])
    assert dense.dim == 64 and dense.emb.dtype == torch.float32
    np.testing.assert_allclose(dense.emb.numpy(),
                               np.asarray(env["jbe"].dense.emb),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", [1 << 21, 1000])
def test_embedding_build_sums_in_entry_order(env, chunk):
    """Each document's row is the float32 sum of its entries' products in
    entry order (numpy's unbuffered ``np.add.at``, as the reference adds
    them), bit for bit, over one chunk or many: the build adds the same
    sequence on the card, where atomics would not."""
    idx = env["tidx"]
    dense = TD.build_dense_index(idx, chunk=chunk)
    proj = TD.projection(idx.vocab, 64, 0, "cpu")
    prods = (proj[idx.fwd_terms.long()] *
             torch.log1p(idx.fwd_tfs.to(torch.float32))[:, None]).numpy()
    starts = idx.fwd_start.numpy()
    doc = np.repeat(np.arange(idx.n_docs), np.diff(starts))
    want = np.zeros((idx.n_docs, 64), np.float32)
    np.add.at(want, doc[:len(prods)], prods)
    want = torch.from_numpy(want)
    want /= torch.linalg.norm(want, dim=1, keepdim=True).clamp(min=1e-6)
    assert torch.equal(dense.emb, want)


def test_query_embedding_matches_reference(env):
    tbe = TorchBackend(env["tidx"], env["tdense"], device="cpu")
    np.testing.assert_array_equal(tbe._qproj.numpy(),
                                  np.asarray(env["jbe"]._qproj))
    np.testing.assert_allclose(tbe.embed_queries(env["tQ"]).numpy(),
                               np.asarray(env["jqv"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_lists,keep_flat", [(N_LISTS, True),
                                               (None, True), (7, False)])
def test_ivf_build_identical_from_equal_embeddings(env, n_lists, keep_flat):
    j = JD.build_ivf_index(env["jbe"].dense, n_lists=n_lists, seed=0,
                           keep_flat=keep_flat)
    t = TD.build_ivf_index(env["tdense"], n_lists=n_lists, seed=0,
                           keep_flat=keep_flat)
    np.testing.assert_array_equal(t.centroids.numpy(), np.asarray(j.centroids))
    np.testing.assert_array_equal(t.doc_ids.numpy(), np.asarray(j.doc_ids))
    np.testing.assert_array_equal(t.list_start.numpy(),
                                  np.asarray(j.list_start))
    assert (t.n_lists, t.max_list_len, t.dim) == \
        (j.n_lists, j.max_list_len, j.dim)
    assert (t.emb is None) == (j.emb is None) == (not keep_flat)
    if keep_flat:
        np.testing.assert_array_equal(t.emb.numpy(), np.asarray(j.emb))
    assert TD.default_n_lists(3000) == JD.default_n_lists(3000)


@pytest.mark.parametrize("m", [8, 16])
def test_pq_build_identical_from_equal_embeddings(env, m):
    j = JD.build_ivfpq_index(env["jbe"].dense, n_lists=N_LISTS, seed=0, m=m)
    t = TD.build_ivfpq_index(env["tdense"], n_lists=N_LISTS, seed=0, m=m)
    np.testing.assert_array_equal(t.codebook.codebooks.numpy(),
                                  np.asarray(j.codebook.codebooks))
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.doc_ids.numpy(), np.asarray(j.doc_ids))
    np.testing.assert_array_equal(t.list_start.numpy(),
                                  np.asarray(j.list_start))
    assert t.emb is env["tdense"].emb          # shared, not copied
    assert TD.pq_store_bytes(t) == JD.pq_store_bytes(j)
    np.testing.assert_allclose(
        TD.pq_decode(t.codebook, t.codes).numpy(),
        np.asarray(JD.pq_decode(j.codebook, j.codes)), rtol=0, atol=0)
    qv = env["tqv"]
    np.testing.assert_allclose(
        TD.adc_table(t.codebook, qv).numpy(),
        np.asarray(jax.vmap(lambda q: JD.adc_table(j.codebook, q))(
            env["jqv"])), rtol=1e-5, atol=1e-6)
    # the ADC-only skeleton keeps no float store
    t2 = TD.build_ivfpq_index(env["tdense"], n_lists=N_LISTS, seed=0, m=m,
                              keep_flat=False)
    assert t2.emb is None


# ---------------------------------------------------------------------------
# search, with the reference's state carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [10, 100])
def test_dense_retrieve_exact_matches_reference(env, k):
    j = _per_query(JD.dense_retrieve_exact, env["jbe"].dense, env["jqv"], k=k)
    for fn in (TD.dense_retrieve_exact, TD.dense_retrieve_exact_fused):
        _agree(j, fn(env["tdense"], env["tqv"], k=k), f"{fn.__name__} k={k}")


@pytest.mark.parametrize("nprobe", [1, 8, N_LISTS])
def test_ivf_retrieve_matches_reference(env, nprobe):
    j = _per_query(JD.ivf_retrieve_topk, env["jivf"], env["jqv"], k=10,
                   nprobe=nprobe)
    for fn in (TD.ivf_retrieve_topk, TD.ivf_retrieve_topk_fused):
        _agree(j, fn(env["tivf"], env["tqv"], k=10, nprobe=nprobe),
               f"{fn.__name__} nprobe={nprobe}")


def test_ivf_pads_candidates_short_of_k(env):
    """nprobe=1 over 150 lists holds fewer than k=60 candidates: the padded
    ranks come out as docid -1 / -inf on both sides."""
    jivf = JD.build_ivf_index(env["jbe"].dense, n_lists=150, seed=0)
    assert jivf.max_list_len < 60
    tivf = _ivf_across(jivf)
    j = _per_query(JD.ivf_retrieve_topk, jivf, env["jqv"], k=60, nprobe=1)
    for fn in (TD.ivf_retrieve_topk, TD.ivf_retrieve_topk_fused):
        t = fn(tivf, env["tqv"], k=60, nprobe=1)
        np.testing.assert_array_equal(t[0].numpy() < 0,
                                      np.asarray(j[0]) < 0)
        assert (t[0] < 0).any() and bool(torch.isinf(t[1][t[0] < 0]).all())
        valid = np.asarray(j[0]) >= 0
        np.testing.assert_array_equal(t[0].numpy()[valid],
                                      np.asarray(j[0])[valid])
        np.testing.assert_allclose(t[1].numpy()[valid],
                                   np.asarray(j[1])[valid], rtol=2e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("nprobe", [1, 8, N_LISTS])
@pytest.mark.parametrize("exact", [True, False], ids=["rescored", "adc"])
def test_ivfpq_retrieve_matches_reference(env, nprobe, exact):
    jpq = env["jpq"] if exact else JD.build_ivfpq_index(
        env["jbe"].dense, n_lists=N_LISTS, seed=0, m=8, keep_flat=False)
    tpq = env["tpq"] if exact else _pq_across(jpq)
    j = _per_query(JD.ivfpq_retrieve_topk, jpq, env["jqv"], k=10,
                   nprobe=nprobe, refine=4)
    for fn in (TD.ivfpq_retrieve_topk, TD.ivfpq_retrieve_topk_fused):
        _agree(j, fn(tpq, env["tqv"], k=10, nprobe=nprobe, refine=4),
               f"{fn.__name__} nprobe={nprobe} exact={exact}")
    # an explicit shortlist depth, as the fusion pass pins it
    j = _per_query(JD.ivfpq_retrieve_topk, jpq, env["jqv"], k=10,
                   nprobe=nprobe, shortlist=70)
    _agree(j, TD.ivfpq_retrieve_topk_fused(tpq, env["tqv"], k=10,
                                           nprobe=nprobe, shortlist=70),
           f"shortlist=70 nprobe={nprobe}")


def test_dense_rerank_matches_reference(env):
    jbe = env["jbe"]
    kw = dict(model="BM25", k_in=200, k=10, alpha=0.3,
              max_postings=jbe.max_postings)
    tmp = int((env["tidx"].term_start[1:] - env["tidx"].term_start[:-1]).max())
    assert tmp == jbe.max_postings
    jQ, tQ = env["jQ"], env["tQ"]
    for jfn, tfn in ((JRT.retrieve_dense_rerank, TRT.retrieve_dense_rerank),
                     (JRT.retrieve_dense_rerank_fused,
                      TRT.retrieve_dense_rerank_fused)):
        j = jax.vmap(lambda t, w, q: jfn(env["jidx"], jbe.dense.emb, t, w, q,
                                         **kw))(jQ["terms"], jQ["weights"],
                                                env["jqv"])
        t = tfn(env["tidx"], env["tdense"].emb, tQ["terms"], tQ["weights"],
                env["tqv"], **kw)
        _agree(j, t, tfn.__name__)


# ---------------------------------------------------------------------------
# passes, run_pipeline and Experiment: D1-D4
# ---------------------------------------------------------------------------

def _pipelines(M):
    """D1-D4 of the port's dense slice, plus the deep-retrieve forms whose
    lowering the JAX package's cost gate also takes."""
    return {"D1": (M.Retrieve("BM25", k=200) >> M.DenseRerank(alpha=0.3)) % 10,
            "D2": M.DenseRetrieve(k=10, nprobe=0) % 10,
            "D3": M.DenseRetrieve(k=10, nprobe=8) % 10,
            "D4": M.DenseRetrieve(k=10, nprobe=8, pq=True) % 10,
            "D2-deep": M.DenseRetrieve(k=200, nprobe=0) % 10,
            "D3-deep": M.DenseRetrieve(k=200, nprobe=8) % 10,
            "D4-deep": M.DenseRetrieve(k=200, nprobe=8, pq=True) % 10}


def _backends(env, caps=DENSE_CAPS):
    """(JAX, torch) backends over one index and one set of embeddings,
    IVF with 16 lists, PQ with m=8; the JAX one sequential."""
    if caps not in env["backends"]:
        kw = dict(default_k=60, query_chunk=4, ivf_lists=N_LISTS, pq_m=8)
        env["backends"][caps] = (
            JaxBackend(env["jidx"], dense=env["jbe"].dense, sharded=False,
                       descriptor=J.BackendDescriptor.default(caps), **kw),
            TorchBackend(env["tidx"], env["tdense"], device="cpu",
                         descriptor=T.BackendDescriptor.default(caps), **kw))
    return env["backends"][caps]


def _kinds(op):
    out = [op.kind]
    for i in op.inputs:
        out.extend(_kinds(i))
    return out


def test_passes_lower_d1_to_d4(env):
    """D1-D4 lower onto the kernels: the port's gate prices each fused
    form strictly cheaper on the op stream (``"source": "estimate"``), and
    a shortlist the PQ kernel does not carry is rejected before any
    estimate (``"kernel_limit"``).  The JAX package's cost gate takes the
    same lowering, with the same parameters, where the fused form prices
    strictly cheaper (a deep retrieve under a shallow cutoff); at k_in ==
    K its HLO estimates tie and it keeps the chain, where the port's eager
    count sees the unfused chain's score rows and sort."""
    jbe, tbe = _backends(env)
    jp, tp = _pipelines(J), _pipelines(T)
    want = {"D1": "fused_dense_rerank", "D2": "fused_dense_retrieve",
            "D3": "fused_dense_retrieve", "D4": "fused_dense_retrieve",
            "D2-deep": "fused_dense_retrieve",
            "D3-deep": "fused_dense_retrieve", "D4-deep": "cutoff"}
    for name, kind in want.items():
        rep = {}
        top = T.compile_pipeline(tp[name], tbe, report=rep)
        assert top.kind == kind, (name, top.kind)
        assert [d["source"] for d in rep["fusion_decisions"]] == \
            ["kernel_limit" if name == "D4-deep" else "estimate"]
        for d in rep["fusion_decisions"]:
            if d["accepted"]:
                assert d["fused_proxy_s"] < d["unfused_proxy_s"]
        if name in ("D1", "D2-deep", "D3-deep"):
            jop = J.compile_pipeline(jp[name], jbe)
            assert jop.kind == kind
            assert {**jop.params, "pq_block": None} == \
                {**top.params, "pq_block": None}
    # the fused D1/D4 stages carry the JAX package's parameters
    d1 = T.compile_pipeline(tp["D1"], tbe)
    assert d1.params == {"model": "BM25", "k_in": 200, "k": 10, "alpha": 0.3}
    d4 = T.compile_pipeline(tp["D4"], tbe)
    r = 4 * 10            # refine * k_in, under 8 * max_list_len candidates
    assert d4.params == {"k": 10, "nprobe": 8, "pq": True, "pq_shortlist": r}


def test_pq_gate_both_branches(env):
    """The shortlist depth r is the unfused chain's (from k_in): k=10 gives
    r = 40 <= 128 and fuses; k=200 gives r = 800 > 128, which the kernel
    does not carry, and stays unfused — exact either way."""
    jbe, tbe = _backends(env)
    reps = []
    for k, kind in ((10, "fused_dense_retrieve"), (200, "cutoff")):
        rep = {}
        pipe = T.DenseRetrieve(k=k, nprobe=8, pq=True) % 10
        assert T.compile_pipeline(pipe, tbe, report=rep).kind == kind
        reps += rep["fusion_decisions"]
        Ro = T.run_pipeline(pipe, env["tQ"], backend=tbe, optimize=True)
        Ru = T.run_pipeline(pipe, env["tQ"], backend=tbe, optimize=False)
        assert torch.equal(Ro["docids"], Ru["docids"])
        assert torch.equal(Ro["scores"], Ru["scores"])
    assert [(d["pattern"], d["accepted"], d["kernel_native"]) for d in reps] \
        == [("pq_topk", True, True), ("pq_topk", False, False)]


# ---------------------------------------------------------------------------
# doc-axis sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_shard_dense_index_offsets_equal_reference(env, n_shards):
    """Contiguous shards at the reference's cuts, each a view of the
    store."""
    got = TD.shard_dense_index(env["tdense"], n_shards)
    want = JD.shard_dense_index(env["jbe"].dense, n_shards)
    assert [o for _, o in got] == [o for _, o in want]
    for (ts, _), (js, _) in zip(got, want):
        np.testing.assert_array_equal(ts.emb.numpy(), np.asarray(js.emb))
        assert ts.emb.data_ptr() >= env["tdense"].emb.data_ptr()
        assert ts.emb._base is env["tdense"].emb
    with pytest.raises(ValueError, match="n_shards"):
        TD.shard_dense_index(env["tdense"], 0)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_dense_topk_equals_unsharded_and_reference(env, n_shards):
    """Per-shard top-k + one merge is bit-equal to the unsharded search
    and to the JAX package's unsharded oracle; the JAX package's own
    sharded form agrees as a ranking (XLA's CPU dot rounds by the shard's
    row count, so it is not bit-equal to its own oracle on this host)."""
    k = 10
    shards = TD.shard_dense_index(env["tdense"], n_shards)
    d, v = TD.sharded_dense_topk(shards, env["tqv"], k=k)
    od, ov = TD.dense_retrieve_exact_fused(env["tdense"], env["tqv"], k=k)
    jd, jv = _per_query(JD.dense_retrieve_exact, env["jbe"].dense,
                        env["jqv"], k=k)
    for want_d, want_v in ((od.numpy(), ov.numpy()),
                           (np.asarray(jd), np.asarray(jv))):
        np.testing.assert_array_equal(d.numpy(), want_d)
        np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                      want_v.view(np.uint32))
    assert d.dtype == torch.int32
    jshards = JD.shard_dense_index(env["jbe"].dense, n_shards)
    _agree(jax.vmap(lambda q: JD.sharded_dense_topk(jshards, q, k=k))(
        env["jqv"]), (d, v), f"sharded {n_shards}")


@pytest.mark.parametrize("caps,want", [
    (frozenset({"fat"}),
     {"D1": "then", "D3": "cutoff", "D3-deep": "cutoff", "D4": "cutoff"}),
    (frozenset({"fat", "fused_dense"}),
     {"D1": "fused_dense_rerank", "D3": "cutoff", "D3-deep": "cutoff",
      "D4": "cutoff"}),
    (frozenset({"fat", "fused_dense", "dense_topk"}),
     {"D1": "fused_dense_rerank", "D3": "fused_dense_retrieve",
      "D3-deep": "fused_dense_retrieve", "D4": "cutoff"})],
    ids=["no-fused_dense", "no-dense_topk", "no-pq_topk"])
def test_dense_fusion_needs_capability(env, caps, want):
    """Without a capability the chain stays interpreted (JAX
    tests/test_dense.py:53,243): fused_dense gates D1, dense_topk the
    flat and brute-force retrieves, pq_topk the PQ retrieve (dense_topk
    alone does not lower it).  The JAX package agrees on D1 and on the
    deep retrieve, whose lowering its cost gate takes when it may."""
    jbe, tbe = _backends(env, caps)
    tp, jp = _pipelines(T), _pipelines(J)
    for name, kind in want.items():
        assert T.compile_pipeline(tp[name], tbe).kind == kind, name
    for name in ("D1", "D3-deep"):
        assert J.compile_pipeline(jp[name], jbe).kind == want[name], name


@pytest.mark.parametrize("optimize", [False, True], ids=["unoptimised",
                                                         "optimised"])
@pytest.mark.parametrize("name", ["D1", "D2", "D3", "D4", "D3-deep"])
def test_run_pipeline_agrees(env, name, optimize):
    jbe, tbe = _backends(env)
    jR = J.run_pipeline(_pipelines(J)[name], env["jQ"], backend=jbe,
                        optimize=optimize)
    tR = T.run_pipeline(_pipelines(T)[name], env["tQ"], backend=tbe,
                        optimize=optimize)
    assert_ranking_parity(np.asarray(jR["docids"]), np.asarray(jR["scores"]),
                          tR["docids"].numpy(), tR["scores"].numpy(),
                          what=f"{name} optimize={optimize}")


def test_dense_rerank_keeps_features_in_step(env):
    """DenseRerank over an F stream re-orders the feature rows with the
    docids (the schema types it F)."""
    _, tbe = _backends(env)
    pipe = (T.Retrieve("BM25", k=30) >> T.Extract("QL")) >> \
        T.DenseRerank(alpha=0.5)
    R = T.run_pipeline(pipe, env["tQ"], backend=tbe, optimize=False)
    base = T.run_pipeline(T.Retrieve("BM25", k=30) >> T.Extract("QL"),
                          env["tQ"], backend=tbe, optimize=False)
    for q in range(R["docids"].shape[0]):
        pos = {int(d): i for i, d in enumerate(base["docids"][q])}
        order = [pos[int(d)] for d in R["docids"][q]]
        assert torch.equal(R["features"][q], base["features"][q][order])
    assert T.compile_pipeline(pipe % 5, tbe).kind == "then"


def test_experiment_map_on_d1_equals_reference(env):
    jbe, tbe = _backends(env)
    metrics = ["map", "ndcg_cut_10"]
    for optimize in (False, True):
        jres = J.Experiment([_pipelines(J)["D1"]], env["jQ"],
                            env["topics"].qrels, metrics, backend=jbe,
                            optimize=optimize, plan=False)
        tres = T.Experiment([_pipelines(T)["D1"]], env["tQ"],
                            env["topics"].qrels, metrics, backend=tbe,
                            optimize=optimize)
        for m in metrics:
            assert abs(tres["table"][0][m] - jres["table"][0][m]) <= 1e-6
