"""The port's algebra, IR, compiler passes, executor and Experiment against
the JAX package, on the tests/conftest.py corpus."""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import ir as jir
from repro.core import passes as jpasses
from repro.core.compiler import JaxBackend
from repro.index.inverted import build_index as jbuild
from repro_torch.core import ir as tir
from repro_torch.core import passes as tpasses
from repro_torch.core.compiler import TorchBackend
from repro_torch.index.inverted import build_index as tbuild

from torch_parity import (ATOL, RTOL, assert_ranking_parity, jax_queries,
                          small_env, torch_queries)

KERNEL_CAPS = frozenset({"fat", "fused_topk", "fused_scoring"})
#: the port's full capability set, which the JAX package also has
PORT_CAPS = frozenset({"pruned_topk", "fat", "fused_topk", "fused_scoring"})


def _pipelines(M):
    """The same pipelines built from either package's stage module."""
    R, X = M.Retrieve, M.Extract
    return [
        R("BM25") % 10,
        (R("BM25") >> (X("QL") ** X("TF_IDF"))) % 20,
        R("QL", k=50) >> X("DPH"),
        (R("BM25", k=30) % 40) % 20,
        (0.5 * R("BM25") + R("QL")) % 15,
        2.0 * (R("TF_IDF") % 10),
        R("BM25", k=20) | R("QL", k=20),
        R("BM25", k=20) & R("QL", k=30),
        R("BM25", k=10) ^ R("DPH", k=10),
        R("BM25") >> X("QL") >> X("Coord"),
    ]


@pytest.fixture(scope="module")
def env():
    corpus, topics, _ = small_env()
    jidx = jbuild(corpus)
    tidx = tbuild(corpus, device="cpu")
    return {"jidx": jidx, "tidx": tidx, "topics": topics,
            "jQ": jax_queries(topics), "tQ": torch_queries(topics),
            "backends": {}}


def _backends(env, caps):
    """(JAX, torch) backends over one index, built once per capability
    set."""
    if caps not in env["backends"]:
        jdesc = None if caps is None else J.BackendDescriptor.default(caps)
        tdesc = None if caps is None else T.BackendDescriptor.default(caps)
        env["backends"][caps] = (
            JaxBackend(env["jidx"], default_k=60, query_chunk=4,
                       sharded=False, descriptor=jdesc),
            TorchBackend(env["tidx"], default_k=60, query_chunk=4,
                         descriptor=tdesc, device="cpu"))
    return env["backends"][caps]


@pytest.mark.parametrize("i", range(10))
def test_keys_and_lowered_ir_identical(i):
    jp, tp = _pipelines(J)[i], _pipelines(T)[i]
    assert tp.key() == jp.key()
    assert repr(tp) == repr(jp)
    assert tir.pretty(tir.lower(tp)) == jir.pretty(jir.lower(jp))
    assert tir.raise_ir(tir.lower(tp)) is tp


@pytest.mark.parametrize("caps", [KERNEL_CAPS, PORT_CAPS,
                                  frozenset({"pruned_topk"})],
                         ids=["kernels", "port-full", "pruned"])
def test_ir_after_rewrite_and_cse_identical(env, caps):
    jbe, tbe = _backends(env, caps)
    jdesc, tdesc = jbe.descriptor, tbe.descriptor
    for jp, tp in zip(_pipelines(J), _pipelines(T)):
        jpm = jpasses.PassManager([
            jpasses.CanonicalizePass(), jpasses.SchemaPass(),
            jpasses.RewritePass(jdesc), jpasses.CSEPass()])
        tpm = tpasses.PassManager([
            tpasses.CanonicalizePass(), tpasses.SchemaPass(),
            tpasses.RewritePass(tdesc), tpasses.CSEPass()])
        jop = jpm.run(jir.lower(jp), jpasses.PassContext(jbe))
        top = tpm.run(tir.lower(tp), tpasses.PassContext(tbe))
        assert top.key() == jop.key()
        assert tir.pretty(top, tpasses.annotate(top, tbe)) == \
            jir.pretty(jop, jpasses.annotate(jop, jbe))


def _assert_results_agree(jR, tR, what):
    ties = assert_ranking_parity(jR["docids"], jR["scores"],
                                 tR["docids"].numpy(), tR["scores"].numpy(),
                                 what=what)
    assert ("features" in tR) == ("features" in jR)
    if "features" in jR:
        same = np.asarray(jR["docids"]) == tR["docids"].numpy()
        np.testing.assert_allclose(tR["features"].numpy()[same],
                                   np.asarray(jR["features"])[same],
                                   rtol=RTOL, atol=ATOL, err_msg=what)
    return ties


SETTINGS = [("unoptimised", None), ("kernels", KERNEL_CAPS), ("full", None)]


@pytest.mark.parametrize("setting", [s for s, _ in SETTINGS])
@pytest.mark.parametrize("which", [0, 1], ids=["rq1", "rq2"])
def test_run_pipeline_agrees(env, setting, which):
    caps = dict(SETTINGS)[setting]
    jbe, tbe = _backends(env, caps)
    optimize = setting != "unoptimised"
    jR = J.run_pipeline(_pipelines(J)[which], env["jQ"], backend=jbe,
                        optimize=optimize)
    tp = _pipelines(T)[which]
    tR = T.run_pipeline(tp, env["tQ"], backend=tbe, optimize=optimize)
    _assert_results_agree(jR, tR, f"{setting} {which}")
    kinds = {("kernels", 0): "fused_topk_retrieve",
             ("kernels", 1): "fused_fat_retrieve",
             ("full", 0): "pruned_retrieve",
             ("full", 1): "fused_fat_retrieve"}
    if optimize:
        assert T.compile_pipeline(tp, tbe).kind == kinds[(setting, which)]


@pytest.mark.parametrize("i", [2, 3, 4, 5, 6, 7, 8, 9])
def test_combinators_agree_unoptimised(env, i):
    jbe, tbe = _backends(env, None)
    jR = J.run_pipeline(_pipelines(J)[i], env["jQ"], backend=jbe,
                        optimize=False)
    tR = T.run_pipeline(_pipelines(T)[i], env["tQ"], backend=tbe,
                        optimize=False)
    if i in (6, 7):       # set operations: docids only, scores are ⊥
        np.testing.assert_array_equal(tR["docids"].numpy(),
                                      np.asarray(jR["docids"]))
        np.testing.assert_array_equal(tR["scores"].numpy(),
                                      np.asarray(jR["scores"]))
    else:
        _assert_results_agree(jR, tR, f"pipeline {i}")


@pytest.mark.parametrize("through", ["tensor", "view"])
def test_shared_context_sees_in_place_edits(env, through):
    """The memo keys a run by a digest of its source tensors; after an
    in-place edit of a query tensor (or of a view of it, which shares its
    version counter) a run with the same Context returns the new results,
    equal to a fresh Context's and to the reference's on the edited
    queries."""
    jbe, tbe = _backends(env, None)
    pipe = T.Retrieve("BM25") % 10
    Q = {key: v.clone() for key, v in env["tQ"].items()}
    ctx = T.Context(tbe)
    before = T.run_pipeline(pipe, Q, backend=tbe, ctx=ctx)
    # every query takes the next one's terms and weights
    for key in ("terms", "weights"):
        rolled = Q[key].roll(1, dims=0)
        target = Q[key] if through == "tensor" else Q[key][:]
        target.copy_(rolled)
    after = T.run_pipeline(pipe, Q, backend=tbe, ctx=ctx)
    fresh = T.run_pipeline(pipe, Q, backend=tbe, ctx=T.Context(tbe))
    assert not torch.equal(after["docids"], before["docids"])
    assert torch.equal(after["docids"], fresh["docids"])
    assert torch.equal(after["scores"], fresh["scores"])
    jQ = J.make_queries(Q["terms"].numpy(), Q["weights"].numpy(),
                        Q["qid"].numpy())
    jR = J.run_pipeline(_pipelines(J)[0], jQ, backend=jbe)
    _assert_results_agree(jR, after, f"edited through a {through}")


def test_experiment_table_equals_reference(env):
    jbe, tbe = _backends(env, None)
    metrics = ["map", "ndcg_cut_10"]
    jres = J.Experiment([J.Retrieve("BM25") % 10, J.Retrieve("QL") % 10],
                        env["jQ"], env["topics"].qrels, metrics, backend=jbe,
                        plan=False)
    tres = T.Experiment([T.Retrieve("BM25") % 10, T.Retrieve("QL") % 10],
                        env["tQ"], env["topics"].qrels, metrics, backend=tbe)
    for jrow, trow in zip(jres["table"], tres["table"]):
        assert trow["name"] == jrow["name"]
        for m in metrics:
            assert abs(trow[m] - jrow[m]) <= 1e-6, (trow, jrow)


def test_experiment_timing_and_planner_refusal(env):
    """The planner no longer refuses: ``plan=True`` is the default, with
    the reference's MRT decomposition; ``plan=False`` keeps the sequential
    path's single ``mrt_ms``."""
    _, tbe = _backends(env, None)
    res = T.Experiment([T.Retrieve("BM25") % 10], env["tQ"],
                       env["topics"].qrels, ["map", "P_5", "recip_rank"],
                       backend=tbe, measure_time=True)
    row = res["table"][0]
    assert row["mrt_ms"] > 0 and set(row) >= {"map", "P_5", "recip_rank"}
    assert row["compile_ms"] >= 0
    assert 0 < row["mrt_shared_ms"] <= row["mrt_ms"] + 1e-9
    assert "mrt_ms" in T.format_table(res["table"])
    assert isinstance(res["plan"], T.ExperimentPlan)
    seq = T.Experiment([T.Retrieve("BM25") % 10], env["tQ"],
                       env["topics"].qrels, backend=tbe, plan=False,
                       measure_time=True)
    assert seq["table"][0]["mrt_ms"] > 0 and "plan" not in seq
    assert set(seq["table"][0]) == {"name", "map", "ndcg_cut_10", "mrt_ms"}


def test_explain_records_capability_decisions(env):
    """A capability opens the gate; the estimate decides (predicted fused
    vs unfused seconds in ``explain()``); a k the kernel does not serve is
    rejected before any estimate."""
    _, tbe = _backends(env, KERNEL_CAPS)
    text = _pipelines(T)[0].explain(tbe)
    assert "FusedTopKRetrieve" in text
    assert "fusion gate [topk]: fused (predicted fused" in text
    assert "kernel_native=True, estimate)" in text
    report = {}
    T.compile_pipeline(T.Retrieve("BM25", k=300) % 200, tbe, report=report)
    (d,) = report["fusion_decisions"]
    assert {k: d[k] for k in ("pattern", "accepted", "kernel_native",
                              "source")} == {
        "pattern": "topk", "accepted": False, "kernel_native": False,
        "source": "kernel_limit"}
    assert report["gate"] == {"gate_decisions": 1, "fused": 0}
    assert report["tuning"]["gate_estimates"] == 0


def test_compile_spans_reach_the_tracer_when_asked(env):
    from repro_torch.obs.tracing import Tracer, set_tracer
    _, tbe = _backends(env, KERNEL_CAPS)
    tracer = set_tracer(Tracer(enabled=True))
    try:
        traced = TorchBackend(env["tidx"], default_k=60, device="cpu",
                              descriptor=tbe.descriptor.with_observability())
        T.compile_pipeline(_pipelines(T)[1], traced)
        names = [r["name"] for r in tracer.records()]
        assert "compile.pipeline" in names and "compile.pass.fusion" in names
        n = len(tracer.records())
        T.compile_pipeline(_pipelines(T)[1], tbe)       # not opted in
        assert len(tracer.records()) == n
    finally:
        set_tracer(None)
