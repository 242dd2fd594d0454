"""The query rewrites (SDM, stemming, RM3), LinearFusion's MultiRetrieve
and the cutoff-soundness rules of the port against the JAX package, on the
tests/conftest.py corpus.

Tolerances: rewritten terms are integers and must be equal; rewritten
weights agree within 1e-6 (RM3 normalises by sums whose order differs);
rankings follow ``torch_parity.assert_ranking_parity`` (scores within
rtol 2e-5 / atol 1e-5, docids equal except inside a score tie).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.compiler import JaxBackend
from repro.index import retrieve as JRT
from repro.index.corpus import synthesize_corpus
from repro.index.inverted import build_index as jbuild
from repro_torch.core.compiler import TorchBackend
from repro_torch.index import retrieve as TRT
from repro_torch.index.inverted import build_index as tbuild

from torch_parity import (assert_ranking_parity, jax_queries, small_env,
                          torch_queries)

W_ATOL = 1e-6
#: the kernel lowerings off: the JAX package's fusion gate is measured and
#: the port's is capability-only, so lowered forms may differ by design
NO_KERNELS = frozenset({"pruned_topk", "fat", "multi_model"})
NO_PRUNE = frozenset({"fat", "multi_model"})


@pytest.fixture(scope="module")
def env():
    corpus, topics, topics_td = small_env()
    jidx = jbuild(corpus)
    tidx = tbuild(corpus, device="cpu")
    return {"jidx": jidx, "tidx": tidx, "topics": topics,
            "forms": {"T": topics, "TD": topics_td}, "backends": {}}


def _backends(env, caps=None):
    if caps not in env["backends"]:
        jdesc = None if caps is None else J.BackendDescriptor.default(caps)
        tdesc = None if caps is None else T.BackendDescriptor.default(caps)
        env["backends"][caps] = (
            JaxBackend(env["jidx"], default_k=60, query_chunk=4,
                       sharded=False, descriptor=jdesc),
            TorchBackend(env["tidx"], default_k=60, query_chunk=4,
                         descriptor=tdesc, device="cpu"))
    return env["backends"][caps]


def _assert_queries_equal(jQ, tQ, what):
    np.testing.assert_array_equal(tQ["terms"].numpy(),
                                  np.asarray(jQ["terms"]), err_msg=what)
    np.testing.assert_allclose(tQ["weights"].numpy(),
                               np.asarray(jQ["weights"]), rtol=0,
                               atol=W_ATOL, err_msg=what)


# ---------------------------------------------------------------------------
# Q -> Q rewrites
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["T", "TD"])
@pytest.mark.parametrize("stage", ["sdm", "stem", "sdm>>stem"])
def test_query_rewrites_equal(env, form, stage):
    jbe, tbe = _backends(env)
    t = env["forms"][form]
    build = {"sdm": lambda M: M.SDMRewrite(),
             "stem": lambda M: M.StemRewrite(weight=0.3),
             "sdm>>stem": lambda M: M.SDMRewrite(0.7) >> M.StemRewrite()}
    jQ = J.run_pipeline(build[stage](J), jax_queries(t), backend=jbe)
    tQ = T.run_pipeline(build[stage](T), torch_queries(t), backend=tbe)
    assert tQ["terms"].dtype == torch.int32
    _assert_queries_equal(jQ, tQ, f"{stage} {form}")


def _rm3_both(jidx, tidx, terms, weights, docids, scores, **kw):
    """rm3_expand of both packages on the same numpy inputs (the JAX op
    vmapped over queries, as its stage runs it)."""
    max_fwd = int(jidx.max_fwd_len)
    ref = jax.vmap(lambda t, w, d, s: JRT.rm3_expand(
        jidx, t, w, d, s, max_fwd=max_fwd, **kw))(
        *(jnp.asarray(a) for a in (terms, weights, docids, scores)))
    out = TRT.rm3_expand(tidx, *(torch.as_tensor(a) for a in
                                 (terms, weights, docids, scores)),
                         max_fwd=max_fwd, **kw)
    return ({"terms": ref[0], "weights": ref[1]},
            {"terms": out[0], "weights": out[1]})


@pytest.mark.parametrize("form", ["T", "TD"])
@pytest.mark.parametrize("fb", [(10, 10, 0.5), (5, 3, 0.7), (20, 25, 0.3)],
                         ids=["fb10x10", "fb5x3", "fb20x25"])
def test_rm3_expand_on_retrieved_feedback(env, form, fb):
    fb_terms, fb_docs, alpha = fb
    jbe, tbe = _backends(env)
    t = env["forms"][form]
    R = T.run_pipeline(T.Retrieve("BM25"), torch_queries(t), backend=tbe)
    Q = torch_queries(t)
    args = [Q["terms"].numpy(), Q["weights"].numpy(),
            R["docids"][:, :fb_docs].numpy(), R["scores"][:, :fb_docs].numpy()]
    jQ, tQ = _rm3_both(env["jidx"], env["tidx"], *args, fb_terms=fb_terms,
                       alpha=alpha)
    _assert_queries_equal(jQ, tQ, f"rm3 {form} {fb}")


def test_rm3_expand_padded_feedback_and_no_results(env):
    """Feedback lists with padded docids (-1, score -inf) after 0..9 real
    ones, and a list with none: its softmax is NaN in the reference, whose
    NaNs rank below every number in the model's top-k, so the expansion
    takes the lowest term ids at weight 0 — in both packages."""
    t = env["forms"]["T"]
    Q = torch_queries(t)
    rng = np.random.default_rng(3)
    nq = Q["terms"].shape[0]
    docids = rng.choice(env["tidx"].n_docs, (nq, 10)).astype(np.int32)
    scores = -np.sort(-rng.random((nq, 10)).astype(np.float32) * 8, 1)
    for q in range(nq):
        n_real = q % 10 + (q == 0)         # 1..9 real docs, then padding
        docids[q, n_real:] = -1
        scores[q, n_real:] = -np.inf
    docids[-1], scores[-1] = -1, -np.inf   # no feedback at all
    jQ, tQ = _rm3_both(env["jidx"], env["tidx"], Q["terms"].numpy(),
                       Q["weights"].numpy(), docids, scores, fb_terms=8,
                       alpha=0.5)
    _assert_queries_equal(jQ, tQ, "rm3 padded feedback")
    assert np.isfinite(np.asarray(jQ["weights"])[-1]).all()


@pytest.fixture(scope="module")
def env0():
    """A corpus indexed with no stopword removal, so that term 0 (the most
    frequent) lies in the documents' vectors."""
    corpus = synthesize_corpus(n_docs=400, vocab=3000, mean_len=40, seed=1)
    return {"jidx": jbuild(corpus, stop_df_fraction=1.0),
            "tidx": tbuild(corpus, stop_df_fraction=1.0, device="cpu")}


def test_rm3_expand_query_holding_term_zero(env0):
    """The reference zeroes a query's own terms with a scatter-set whose
    padded slots write term 0's value back after the real slots: term 0 is
    zeroed only when no padded slot follows it.  Rows: term 0 first, in
    the middle, in a full 48-term query, and absent; with and without
    feedback documents."""
    jidx, tidx = env0["jidx"], env0["tidx"]
    assert int((tidx.fwd_terms == 0).sum()) > 0
    terms = np.full((6, 48), -1, np.int32)
    weights = np.zeros((6, 48), np.float32)
    terms[0, :3], terms[1, :3] = [0, 17, 40], [7, 0, 9]
    terms[2] = np.arange(48)
    terms[3, :2] = [5, 11]
    terms[4, :2] = [0, 3]
    terms[5, :1] = [0]
    weights[terms >= 0] = 1.0
    weights[1, :3] = [0.5, 2.0, 1.0]
    rng = np.random.default_rng(0)
    docids = rng.choice(tidx.n_docs, (6, 10)).astype(np.int32)
    scores = -np.sort(-rng.random((6, 10)).astype(np.float32) * 5, 1)
    docids[4], scores[4] = -1, -np.inf
    docids[5, 4:], scores[5, 4:] = -1, -np.inf
    jQ, tQ = _rm3_both(jidx, tidx, terms, weights, docids, scores,
                       fb_terms=7, alpha=0.4)
    _assert_queries_equal(jQ, tQ, "rm3 term 0")
    # term 0 came back as an expansion term: not zeroed, as in the reference
    assert (tQ["terms"][0, 3:] == 0).any()


@pytest.mark.parametrize("fb", [(10, 10), (5, 3)], ids=["fb10x10", "fb5x3"])
def test_rm3_pipeline_rankings(env, fb):
    jbe, tbe = _backends(env)
    t = env["forms"]["T"]

    def pipe(M):
        return (M.Retrieve("BM25") >> M.RM3Expand(fb_terms=fb[0], fb_docs=fb[1])
                >> M.Retrieve("BM25"))

    jR = J.run_pipeline(pipe(J), jax_queries(t), backend=jbe)
    tR = T.run_pipeline(pipe(T), torch_queries(t), backend=tbe)
    assert_ranking_parity(jR["docids"], jR["scores"], tR["docids"].numpy(),
                          tR["scores"].numpy(), what=f"rm3 pipeline {fb}")


# ---------------------------------------------------------------------------
# LinearFusion -> MultiRetrieve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights,k", [((0.5, 0.5), None), ((0.7, 0.3), 30)],
                         ids=["0.5/0.5", "0.7/0.3@30"])
def test_linear_fusion_multi_retrieve(env, weights, k):
    """``(w1·BM25 + w2·QL) % 20`` compiles to ``cutoff(multi_retrieve)`` in
    both packages; its rankings equal the reference's MultiRetrieve's, the
    port's unfused Linear equals the reference's, and fused against
    unfused keeps the reference's own law
    (tests/test_algebra.py::test_linear_fusion_exact: at least 9 of the
    top 10 shared per query).  The cutoff keeps the comparison of the
    unfused CombSUM off the children's last ranks, where QL's long runs of
    tied scores (each an ulp apart between torch's and XLA's ``log``)
    decide which documents enter a child's list."""
    jbe, tbe = _backends(env)
    t = env["forms"]["T"]

    def pipe(M):
        return (weights[0] * M.Retrieve("BM25", k=k)
                + weights[1] * M.Retrieve("QL", k=k)) % 20

    jop, top = J.compile_pipeline(pipe(J), jbe), T.compile_pipeline(pipe(T),
                                                                     tbe)
    assert top.kind == "cutoff"
    assert jop.inputs[0].kind == top.inputs[0].kind == "multi_retrieve"
    assert top.key() == jop.key()
    R = {}
    for name, opt in (("fused", True), ("unfused", False)):
        jR = J.run_pipeline(pipe(J), jax_queries(t), backend=jbe,
                            optimize=opt)
        tR = T.run_pipeline(pipe(T), torch_queries(t), backend=tbe,
                            optimize=opt)
        assert_ranking_parity(jR["docids"], jR["scores"],
                              tR["docids"].numpy(), tR["scores"].numpy(),
                              what=f"linear {name}")
        R[name] = tR["docids"].numpy()
    for a, b in zip(R["fused"], R["unfused"]):
        assert len(set(a[:10].tolist()) & set(b[:10].tolist())) >= 9


# ---------------------------------------------------------------------------
# cutoff soundness (tests/test_rewrite_soundness.py's cases)
# ---------------------------------------------------------------------------

def _soundness_pipes(M):
    R, S, St, R3 = M.Retrieve, M.SDMRewrite, M.StemRewrite, M.RM3Expand
    return {
        "lands-on-retrieve": (R("BM25", k=30) >> S()) % 10,
        "hops-two-rewrites": (R("BM25", k=30) >> S() >> St()) % 10,
        "blocked-by-rm3": (R("BM25", k=30) >> R3(fb_docs=5)) % 10,
        "past-rm3-onto-retrieve": (R("BM25", k=30) >> R3(fb_docs=5)
                                   >> R("BM25", k=30)) % 10,
    }


@pytest.mark.parametrize("caps", [NO_KERNELS, NO_PRUNE],
                         ids=["prune", "no-prune"])
@pytest.mark.parametrize("case", list(_soundness_pipes(T)))
def test_cutoff_soundness_same_op_trees(env, caps, case):
    jbe, tbe = _backends(env, caps)
    jtrace, ttrace = [], []
    jop = J.compile_pipeline(_soundness_pipes(J)[case], jbe, trace=jtrace)
    top = T.compile_pipeline(_soundness_pipes(T)[case], tbe, trace=ttrace)
    assert top.key() == jop.key()
    from repro.core import ir as jir
    from repro_torch.core import ir as tir
    assert tir.pretty(top) == jir.pretty(jop)
    assert [n for n, *_ in ttrace] == [n for n, *_ in jtrace]
    if case == "blocked-by-rm3":
        assert top.kind == "cutoff"
        assert "cutoff_into_then" not in [n for n, *_ in ttrace]


@pytest.mark.parametrize("k,names", [
    (10, ["sdm"]), (5, ["stem", "sdm"]), (10, ["rm3"]),
    (7, ["sdm", "rm3"]), (12, []),
])
def test_cutoff_rewrite_preserves_rankings_fixed(env, k, names):
    """Optimised equals unoptimised on the no-pruning backend, exactly, in
    the port; and both equal the reference's."""
    jbe, tbe = _backends(env, NO_PRUNE)
    t = env["forms"]["T"]

    def pipe(M):
        trailing = {"sdm": M.SDMRewrite, "stem": M.StemRewrite,
                    "rm3": lambda: M.RM3Expand(fb_docs=5, fb_terms=5)}
        p = M.Retrieve("BM25", k=30)
        for n in names:
            p = p >> trailing[n]()
        return p % k

    Ro = T.run_pipeline(pipe(T), torch_queries(t), backend=tbe)
    Ru = T.run_pipeline(pipe(T), torch_queries(t), backend=tbe,
                        optimize=False)
    assert torch.equal(Ro["docids"], Ru["docids"])
    torch.testing.assert_close(Ro["scores"], Ru["scores"], rtol=1e-6,
                               atol=0)
    jR = J.run_pipeline(pipe(J), jax_queries(t), backend=jbe)
    assert_ranking_parity(jR["docids"], jR["scores"], Ro["docids"].numpy(),
                          Ro["scores"].numpy(), what=f"soundness {names}")
