"""The port's Experiment planner (``core/plan.py``): the cases of
tests/test_plan.py, each held as the port's own invariant and, where the
reference gives a result, against the JAX package's plan on the same
pipelines — stage executions and requests equal, rankings equal except
inside a score tie (``torch_parity``)."""
import gc
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.compiler import JaxBackend
from repro.index.inverted import build_index as jbuild
from repro_torch.core.compiler import Context, TorchBackend
from repro_torch.core.data import make_queries
from repro_torch.core.plan import backend_digest
from repro_torch.core.transformer import Generic
from repro_torch.index.inverted import build_index as tbuild

from torch_parity import (assert_ranking_parity, jax_queries, small_env,
                          torch_queries)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def env():
    corpus, topics, _ = small_env()
    jidx = jbuild(corpus)
    tidx = tbuild(corpus, device="cpu")
    jbe = JaxBackend(jidx, default_k=60, query_chunk=4, sharded=False)
    tbe = TorchBackend(tidx, default_k=60, query_chunk=4, device="cpu")
    return {"jidx": jidx, "tidx": tidx, "jbe": jbe, "tbe": tbe,
            "topics": topics, "jQ": jax_queries(topics),
            "Q": torch_queries(topics)}


def _counting_probe(M):
    calls = {"n": 0}

    def fn(Q, R):
        calls["n"] += 1
        return Q, R

    return M.transformer.Generic(fn=fn) if M is J else Generic(fn=fn), calls


def _same_plan_shape(env, build, optimize):
    """The port's and the reference's plans of ``build(M)``: equal
    executions and requests; returns the port's plan."""
    jplan = J.ExperimentPlan(build(J), env["jbe"], optimize=optimize)
    tplan = T.ExperimentPlan(build(T), env["tbe"], optimize=optimize)
    assert tplan.n_stage_executions == jplan.n_stage_executions
    assert tplan.n_stage_requests == jplan.n_stage_requests
    return tplan


def _assert_rankings(jRs, tRs, what):
    for i, (jR, tR) in enumerate(zip(jRs, tRs)):
        assert_ranking_parity(jR["docids"], jR["scores"],
                              tR["docids"].numpy(), tR["scores"].numpy(),
                              what=f"{what} {i}")


# ---------------------------------------------------------------------------
# exactly-once shared-prefix execution
# ---------------------------------------------------------------------------

def test_shared_prefix_executes_exactly_once(env):
    """BM25 >> A and BM25 >> B must run BM25 (and the probe) once."""
    probe, calls = _counting_probe(T)

    def build(M):
        base = M.Retrieve("BM25", k=10) >> _counting_probe(M)[0]
        return [base >> M.Extract("QL"), base >> M.Extract("TF_IDF")]

    _same_plan_shape(env, build, optimize=False)
    base = T.Retrieve("BM25", k=10) >> probe
    ctx = Context(env["tbe"])
    plan = T.ExperimentPlan([base >> T.Extract("QL"),
                             base >> T.Extract("TF_IDF")], env["tbe"],
                            optimize=False)
    plan.execute(env["Q"], ctx=ctx)
    assert calls["n"] == 1
    assert ctx.exec_counts[T.Retrieve("BM25", k=10).key()] == 1
    assert plan.n_stage_executions == 4       # BM25, probe, 2x Extract
    assert plan.n_stage_requests == 6


@pytest.mark.parametrize("share_cache", [True, False])
def test_sequential_share_cache(env, share_cache):
    """``plan=False``: a shared memo runs BM25 >> probe once across the two
    pipelines, ``share_cache=False`` a fresh memo each runs it twice — in
    the port as in the reference."""
    counts = {}
    for M, Q, be in ((J, env["jQ"], env["jbe"]), (T, env["Q"], env["tbe"])):
        probe, calls = _counting_probe(M)
        base = M.Retrieve("BM25", k=10) >> probe
        M.Experiment([base >> M.Extract("QL"), base >> M.Extract("TF_IDF")],
                     Q, env["topics"].qrels, ["map"], backend=be,
                     optimize=False, plan=False, share_cache=share_cache)
        counts[M.__name__] = calls["n"]
    assert counts == {"repro.core": 1 if share_cache else 2,
                      "repro_torch.core": 1 if share_cache else 2}


def test_plan_trie_shares_structurally_equal_stages(env):
    def build(M):
        return [M.Retrieve("BM25", k=10) >> M.Extract("QL"),
                M.Retrieve("BM25", k=10) >> M.Extract("TF_IDF")]

    plan = _same_plan_shape(env, build, optimize=False)
    ctx = Context(env["tbe"])
    res = plan.execute(env["Q"], ctx=ctx)
    assert ctx.exec_counts[T.Retrieve("BM25", k=10).key()] == 1
    jres = J.ExperimentPlan(build(J), env["jbe"], optimize=False).execute(
        env["jQ"])
    _assert_rankings(jres, res, "shared")
    for jR, tR in zip(jres, res):
        same = np.asarray(jR["docids"]) == tR["docids"].numpy()
        np.testing.assert_allclose(tR["features"].numpy()[same],
                                   np.asarray(jR["features"])[same],
                                   rtol=2e-5, atol=1e-5)


def test_three_way_trie_fanout(env):
    def build(M):
        return [M.Retrieve("BM25", k=20) % 5,
                M.Retrieve("BM25", k=20) >> M.DenseRerank(alpha=0.5),
                M.Retrieve("BM25", k=20) >> M.Extract("QL")]

    plan = _same_plan_shape(env, build, optimize=False)
    ctx = Context(env["tbe"])
    res = plan.execute(env["Q"], ctx=ctx)
    assert len(res) == 3 and all(r is not None for r in res)
    assert ctx.exec_counts[T.Retrieve("BM25", k=20).key()] == 1


# ---------------------------------------------------------------------------
# cache-token soundness
# ---------------------------------------------------------------------------

def test_tokens_are_content_addressed(env):
    ctx = Context(env["tbe"])
    terms = np.array([[1, 2, 3]], np.int32)
    Q1 = make_queries(terms, device="cpu")
    Q2 = make_queries(terms.copy(), device="cpu")
    Q3 = make_queries(np.array([[4, 5, 6]], np.int32), device="cpu")
    assert ctx.source_token(Q1, None) == ctx.source_token(Q2, None)
    assert ctx.source_token(Q1, None) != ctx.source_token(Q3, None)


def test_memo_survives_gc_pressure(env):
    be = env["tbe"]
    ctx = Context(be)
    pipe = T.Retrieve("BM25", k=10)
    terms = env["Q"]["terms"].numpy()[:, :3]
    Q1 = make_queries(terms, device="cpu")
    R1 = pipe.transform(Q1, backend=be, optimize=False, ctx=ctx)
    R1_docs = R1["docids"].clone()
    del Q1, R1
    gc.collect()
    decoys = [make_queries(np.roll(terms, s, axis=1), device="cpu")
              for s in range(1, 4)]
    Q2 = make_queries(terms[::-1].copy(), device="cpu")
    R2 = pipe.transform(Q2, backend=be, optimize=False, ctx=ctx)
    ref = pipe.transform(Q2, backend=be, optimize=False, ctx=Context(be))
    assert torch.equal(R2["docids"], ref["docids"])
    n0 = ctx.exec_counts[pipe.key()]
    R1b = pipe.transform(make_queries(terms.copy(), device="cpu"),
                         backend=be, optimize=False, ctx=ctx)
    assert torch.equal(R1b["docids"], R1_docs)
    assert ctx.exec_counts[pipe.key()] == n0     # memo hit, no re-execution
    assert len(decoys) == 3


# ---------------------------------------------------------------------------
# plan vs sequential equality
# ---------------------------------------------------------------------------

def _system_pipes(M):
    return [
        M.Retrieve("BM25", k=30),
        M.Retrieve("QL", k=30),
        M.Retrieve("BM25", k=30) >> M.RM3Expand(fb_terms=5, fb_docs=5)
        >> M.Retrieve("BM25", k=30),
        M.SDMRewrite() >> M.Retrieve("BM25", k=10),
        M.Retrieve("BM25", k=20) >> M.DenseRerank(alpha=0.5),
    ]


@pytest.mark.parametrize("optimize", [False, True])
def test_plan_matches_sequential_results(env, optimize):
    """Planned equals sequential in the port (docids equal, scores within
    1e-6, map within 1e-6), and the planned rankings equal the
    reference's."""
    planned = T.Experiment(_system_pipes(T), env["Q"], env["topics"].qrels,
                           ["map"], backend=env["tbe"], optimize=optimize)
    seq = T.Experiment(_system_pipes(T), env["Q"], env["topics"].qrels,
                       ["map"], backend=env["tbe"], optimize=optimize,
                       plan=False)
    for Rp, Rs in zip(planned["results"], seq["results"]):
        assert torch.equal(Rp["docids"], Rs["docids"])
        torch.testing.assert_close(Rp["scores"], Rs["scores"], rtol=1e-6,
                                   atol=0)
    for rp, rs in zip(planned["table"], seq["table"]):
        assert abs(rp["map"] - rs["map"]) <= 1e-6
    jres = J.Experiment(_system_pipes(J), env["jQ"], env["topics"].qrels,
                        ["map"], backend=env["jbe"], optimize=optimize)
    _assert_rankings(jres["results"], planned["results"], "planned")
    assert planned["plan"].n_stage_executions == \
        jres["plan"].n_stage_executions
    assert planned["plan"].n_stage_requests == jres["plan"].n_stage_requests


# ---------------------------------------------------------------------------
# MRT decomposition
# ---------------------------------------------------------------------------

def test_mrt_decomposes_compile_and_steady(env):
    res = T.Experiment([T.Retrieve("BM25", k=30), T.Retrieve("QL", k=30)],
                       env["Q"], env["topics"].qrels, ["map"],
                       backend=env["tbe"], measure_time=True)
    for row in res["table"]:
        assert row["mrt_ms"] > 0
        assert row["compile_ms"] >= 0
        assert 0 < row["mrt_shared_ms"] <= row["mrt_ms"] + 1e-9
    st = res["stage_table"]
    assert all(r["steady_ms"] is not None for r in st)
    assert {r["n_pipelines"] for r in st} == {1}
    assert {"cold_ms", "compile_ms", "cache_hit"} <= set(st[0])


def test_mrt_shared_amortises(env):
    base = T.Retrieve("BM25", k=20)
    res = T.Experiment([base >> T.Extract("QL"), base >> T.Extract("TF_IDF")],
                       env["Q"], env["topics"].qrels, ["map"],
                       backend=env["tbe"], optimize=False, measure_time=True)
    for row in res["table"]:
        assert row["mrt_shared_ms"] < row["mrt_ms"]


# ---------------------------------------------------------------------------
# on-disk artifact cache
# ---------------------------------------------------------------------------

def test_artifact_cache_roundtrip(env, tmp_path):
    def build(M):
        return [M.Retrieve("BM25", k=20) >> M.Extract("QL"),
                M.Retrieve("BM25", k=20) >> M.Extract("TF_IDF")]

    cache = T.ArtifactCache(tmp_path / "artifacts")
    r1 = T.Experiment(build(T), env["Q"], env["topics"].qrels, ["map"],
                      backend=env["tbe"], optimize=False,
                      artifact_cache=cache)
    assert cache.hits == 0 and cache.misses > 0
    cache2 = T.ArtifactCache(tmp_path / "artifacts")
    ctx = Context(env["tbe"])
    plan = T.ExperimentPlan(build(T), env["tbe"], optimize=False)
    res2 = plan.execute(env["Q"], ctx=ctx, cache=cache2)
    assert cache2.hits == plan.n_stage_executions
    assert not ctx.exec_counts                      # zero stage executions
    for Ra, Rb in zip(r1["results"], res2):
        assert Rb["docids"].device.type == "cpu"
        assert torch.equal(Ra["docids"], Rb["docids"])
        assert torch.equal(Ra["features"], Rb["features"])
    jres = J.Experiment(build(J), env["jQ"], env["topics"].qrels, ["map"],
                        backend=env["jbe"], optimize=False)
    _assert_rankings(jres["results"], res2, "from disk")


def test_artifact_cache_keys_on_query_content(env, tmp_path):
    pipe = [T.Retrieve("BM25", k=10)]
    cache = T.ArtifactCache(tmp_path / "a")
    T.Experiment(pipe, env["Q"], env["topics"].qrels, ["map"],
                 backend=env["tbe"], artifact_cache=tmp_path / "a")
    other = make_queries(env["Q"]["terms"].numpy()[:4], device="cpu")
    plan = T.ExperimentPlan(pipe, env["tbe"])
    res = plan.execute(other, ctx=Context(env["tbe"]), cache=cache)
    assert cache.hits == 0                           # no false sharing
    assert res[0]["docids"].shape[0] == 4


def test_duplicate_pipelines_share_one_leaf(env):
    p = T.Retrieve("BM25", k=15)
    res = T.Experiment([p, p], env["Q"], env["topics"].qrels, ["map"],
                       backend=env["tbe"])
    jp = J.Retrieve("BM25", k=15)
    jres = J.Experiment([jp, jp], env["jQ"], env["topics"].qrels, ["map"],
                        backend=env["jbe"])
    assert res["plan"].n_stage_executions == \
        jres["plan"].n_stage_executions == 1
    assert all(r is not None for r in res["results"])
    assert torch.equal(res["results"][0]["docids"],
                       res["results"][1]["docids"])


def test_artifact_cache_keys_on_backend_config(env, tmp_path):
    """Retrieve(k=None) resolves k from backend.default_k at run time; two
    backends over the same index but different default_k must not share
    artifacts.  Equal index bytes in another tensor give the same digest,
    a changed one another."""
    cache = T.ArtifactCache(tmp_path / "b")
    pipe = [T.Retrieve("BM25")]
    be40 = TorchBackend(env["tidx"], default_k=40, query_chunk=4,
                        device="cpu")
    be20 = TorchBackend(env["tidx"], default_k=20, query_chunk=4,
                        device="cpu")
    r1 = T.ExperimentPlan(pipe, be40).execute(env["Q"], cache=cache)
    r2 = T.ExperimentPlan(pipe, be20).execute(env["Q"], cache=cache)
    assert cache.hits == 0                       # no cross-config aliasing
    assert r1[0]["docids"].shape[1] == 40
    assert r2[0]["docids"].shape[1] == 20
    import dataclasses
    copy = dataclasses.replace(env["tidx"], **{
        n: a.clone() for n, a in env["tidx"].arrays().items()})
    assert backend_digest(TorchBackend(copy, default_k=40, device="cpu")) \
        == backend_digest(be40)
    copy.tfs[0] += 1
    assert backend_digest(TorchBackend(copy, default_k=40, device="cpu")) \
        != backend_digest(be40)


def test_stateful_and_object_stages_never_persisted(env, tmp_path):
    """Stages keyed by process-local state — a Generic's function, a
    stateful LTR stage's (uid, version) — are not written to disk."""
    probe, _ = _counting_probe(T)
    feats = (T.Retrieve("BM25", k=10) >> (T.Extract("QL") **
                                          T.Extract("DPH")))
    pipes = [T.Retrieve("BM25", k=10) >> probe,
             feats >> T.LTRRerank(n_features=2)]
    cache = T.ArtifactCache(tmp_path / "c")
    plan = T.ExperimentPlan(pipes, env["tbe"], optimize=False)
    plan.execute(env["Q"], ctx=Context(env["tbe"]), cache=cache)
    files = list((tmp_path / "c").glob("*.npz"))
    # the Retrieve prefix and the feature union: not the Generic, not LTR
    assert len(files) == 2
    assert plan.n_stage_executions == 4


_TWO_PROCESS = """
import hashlib, json, sys
import repro_torch as rt
from repro_torch.index.corpus import synthesize_corpus, synthesize_topics
corpus = synthesize_corpus(n_docs=1500, vocab=6000, mean_len=60, seed=5)
topics = synthesize_topics(corpus, n_topics=6, q_len=3, rels_per_topic=8,
                           seed=6)
be = rt.TorchBackend(rt.build_index(corpus, device="cpu"), default_k=30,
                     device="cpu")
Q = rt.make_queries(topics.terms, topics.weights, topics.qids, device="cpu")
bm25 = rt.Retrieve("BM25")
pipes = [bm25, bm25 >> rt.RM3Expand(fb_docs=5, fb_terms=5) >> rt.Retrieve("BM25"),
         rt.SDMRewrite() >> rt.StemRewrite() >> rt.Retrieve("BM25")]
cache = rt.ArtifactCache(sys.argv[1])
res = rt.Experiment(pipes, Q, topics.qrels, ["map"], backend=be,
                    artifact_cache=cache)
h = hashlib.sha256()
for R in res["results"]:
    h.update(R["docids"].numpy().tobytes())
    h.update(R["scores"].numpy().tobytes())
print(json.dumps({"hits": cache.hits, "misses": cache.misses,
                  "rankings": h.hexdigest()}))
"""


def test_artifact_cache_across_two_processes(tmp_path):
    """Two processes, one cache directory: the second serves its stages
    from the first's artifacts and returns the same rankings, bit for
    bit."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    outs = []
    for _ in range(2):
        p = subprocess.run([sys.executable, "-c", _TWO_PROCESS,
                            str(tmp_path / "shared")], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr
        outs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    first, second = outs
    assert first["hits"] == 0 and first["misses"] == 6
    assert second["hits"] == 6 and second["misses"] == 0
    assert second["rankings"] == first["rankings"]


def test_chain_prefix_digests_equal_reference_and_move_with_fit(env):
    """The cumulative digests of a compiled chain equal the reference's
    for the same stateless pipeline (the keys are equal), and a fit moves
    every digest from the stateful stage on."""
    from repro.core.plan import chain_prefix_digests as jdigests
    from repro_torch.core.plan import chain_prefix_digests, stage_chain

    def build(M):
        return (M.Retrieve("BM25") >> M.RM3Expand(fb_docs=5, fb_terms=5)
                >> M.Retrieve("BM25", k=20))

    jchain = J.plan.stage_chain(J.compile_pipeline(build(J), env["jbe"]))
    tchain = stage_chain(T.compile_pipeline(build(T), env["tbe"]))
    assert chain_prefix_digests(tchain, scope="s") == \
        jdigests(jchain, scope="s")
    ltr = T.LTRRerank(n_features=2, epochs=2)
    pipe = (T.Retrieve("BM25", k=20) >> (T.Extract("QL") ** T.Extract("DPH"))
            >> ltr)
    before = chain_prefix_digests(stage_chain(pipe))
    pipe.fit(env["Q"], env["topics"].qrels, backend=env["tbe"])
    after = chain_prefix_digests(stage_chain(pipe))
    assert before[:2] == after[:2] and before[2] != after[2]


def test_plan_spans_reach_the_tracer_when_asked(env):
    """``plan.execute`` and one ``plan.stage`` span a trie node, nested as
    the trie, when the backend's descriptor opts in; none otherwise."""
    from repro_torch.obs.tracing import Tracer, set_tracer
    tracer = set_tracer(Tracer(enabled=True))
    try:
        traced = TorchBackend(env["tidx"], default_k=60, query_chunk=4,
                              device="cpu",
                              descriptor=T.BackendDescriptor.default()
                              .with_observability())
        base = T.Retrieve("BM25", k=10)
        pipes = [base >> T.Extract("QL"), base >> T.Extract("DPH")]
        T.ExperimentPlan(pipes, traced, optimize=False).execute(env["Q"])
        recs = [r for r in tracer.records() if r["cat"] == "plan"]
        names = [r["name"] for r in recs]
        assert names.count("plan.execute") == 1
        assert names.count("plan.stage") == 3
        n = len(tracer.records())
        T.ExperimentPlan(pipes, env["tbe"], optimize=False).execute(env["Q"])
        assert len(tracer.records()) == n
    finally:
        set_tracer(None)
