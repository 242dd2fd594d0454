"""The learning-to-rank stage, the training protocol (``fit_pipeline``,
``Transformer.fit``, ``label_results``) and the tuning module (grid search,
k-fold cross-validation) of the port against the JAX package, on the
tests/conftest.py corpus.

The port's LTRRerank draws its state from a torch generator, so every
comparison starts both stages from the JAX stage's state, carried across
with ``models.ltr.ltr_state_from_arrays``.

Tolerances.  Scores of one state: rtol 2e-5 / atol 1e-5
(``torch_parity``), the tanh and the matmuls round differently.  A fitted
state: the loss sums its [NQ, K, K] pairs in another order than XLA does,
and each of 30 steps feeds the next, so the fitted weights agree within
``STATE_ATOL`` / ``STATE_RTOL`` — on this corpus, 30 epochs at K = 40, the
largest difference measured on the CPU was 1.2e-7 (w1, whose entries reach
1.55), and the bound leaves 8x room.  Rankings of fitted states: equal
except inside a score tie.  Cross-validated measures: ``MEASURE_ATOL``,
the measures of rankings equal but for ties.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import tuning as jtuning
from repro.core.compiler import JaxBackend
from repro.index.inverted import build_index as jbuild
from repro_torch.core import tuning as ttuning
from repro_torch.core.compiler import TorchBackend, fit_pipeline
from repro_torch.core.transformer import Generic
from repro_torch.index.inverted import build_index as tbuild
from repro_torch.models.ltr import LTRModel, ltr_state_from_arrays

from torch_parity import (assert_ranking_parity, jax_queries, small_env,
                          torch_queries)

STATE_ATOL, STATE_RTOL = 1e-6, 1e-5
MEASURE_ATOL = 1e-6
FEATURES = ("QL", "TF_IDF", "DPH")


@pytest.fixture(scope="module")
def env():
    corpus, topics, topics_td = small_env()
    jbe = JaxBackend(jbuild(corpus), default_k=60, query_chunk=4,
                     sharded=False)
    tbe = TorchBackend(tbuild(corpus, device="cpu"), default_k=60,
                       query_chunk=4, device="cpu")
    return {"jbe": jbe, "tbe": tbe, "topics": topics, "td": topics_td}


def _ltr_pair(seed=0, **kw):
    """A JAX LTRRerank and the port's, both holding the JAX stage's state."""
    jl = J.LTRRerank(n_features=len(FEATURES), seed=seed, **kw)
    tl = T.LTRRerank(n_features=len(FEATURES), seed=seed, **kw)
    tl.state = ltr_state_from_arrays(
        {k: np.asarray(v) for k, v in jl.state.items()}, "cpu")
    return jl, tl


def _features(M, k=40):
    fu = M.Extract(FEATURES[0])
    for m in FEATURES[1:]:
        fu = fu ** M.Extract(m)
    return (M.Retrieve("BM25") >> fu) % k


def _assert_state_close(jl, tl):
    for name in ("w1", "b1", "w2"):
        np.testing.assert_allclose(
            getattr(tl.state, name).detach().numpy(),
            np.asarray(jl.state[name]), rtol=STATE_RTOL, atol=STATE_ATOL,
            err_msg=name)


def test_label_results_equal(env):
    t = env["topics"]
    R = T.run_pipeline(T.Retrieve("BM25"), torch_queries(t),
                       backend=env["tbe"])
    R["docids"][0, 5:] = -1            # padded ranks grade 0
    out = env["tbe"].label_results(torch_queries(t), R, t.qrels)
    ref = env["jbe"].label_results(jax_queries(t),
                                   {"docids": R["docids"].numpy()}, t.qrels)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.sum() > 0


def test_ltr_state_from_arrays_and_init():
    jl, tl = _ltr_pair(seed=3, hidden=8)
    assert isinstance(tl.state, LTRModel)
    assert tuple(tl.state.w1.shape) == (3, 8)
    assert tuple(tl.state.w2.shape) == (8, 1)
    # a stage left to draw its own state draws it on the backend's device
    fresh = T.LTRRerank(n_features=3, hidden=8, seed=3)
    assert fresh.state is None
    tbe = type("Be", (), {"device": torch.device("cpu")})()
    m = fresh._model(tbe)
    again = T.LTRRerank(n_features=3, hidden=8, seed=3)._model(tbe)
    assert torch.equal(m.w1, again.w1) and not torch.equal(m.w1, tl.state.w1)
    assert float(m.b1.detach().abs().max()) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_ltr_scores_from_carried_state(env, seed):
    jl, tl = _ltr_pair(seed=seed)
    t = env["topics"]
    jR = J.run_pipeline(_features(J) >> jl, jax_queries(t),
                        backend=env["jbe"])
    tR = T.run_pipeline(_features(T) >> tl, torch_queries(t),
                        backend=env["tbe"])
    assert_ranking_parity(jR["docids"], jR["scores"], tR["docids"].numpy(),
                          tR["scores"].numpy(), what=f"ltr seed {seed}")


@pytest.mark.parametrize("form", ["T", "TD"])
def test_fit_matches_reference(env, form):
    """30 epochs from one state: the fitted weights within the stated
    tolerance, the version bumped, and rankings equal except inside ties.
    The compiled pipeline holds the fitted stage itself, and its key moved
    with the version, so a shared Context does not serve the unfitted
    scores."""
    t = env["topics"] if form == "T" else env["td"]
    jl, tl = _ltr_pair(epochs=30)
    jp, tp = _features(J) >> jl, _features(T) >> tl
    ctx = T.Context(env["tbe"])
    before = T.run_pipeline(tp, torch_queries(t), backend=env["tbe"],
                            ctx=ctx)
    key0 = tl.key()
    assert jp.fit(jax_queries(t), t.qrels, backend=env["jbe"]) is jp
    assert tp.fit(torch_queries(t), t.qrels, backend=env["tbe"]) is tp
    assert tl.version == jl.version == 1 and tl.key() != key0
    _assert_state_close(jl, tl)
    op = T.compile_pipeline(tp, env["tbe"])
    assert [o.kind for o in op.inputs] == ["fused_fat_retrieve", "ltr"]
    assert op.inputs[1].ref is tl
    tR = T.run_pipeline(tp, torch_queries(t), backend=env["tbe"], ctx=ctx)
    assert not torch.equal(tR["scores"], before["scores"])
    jR = J.run_pipeline(jp, jax_queries(t), backend=env["jbe"])
    assert_ranking_parity(jR["docids"], jR["scores"], tR["docids"].numpy(),
                          tR["scores"].numpy(), what=f"fitted {form}")


def test_fit_pipeline_with_validation_stream(env):
    """fit_pipeline walks the uncompiled tree with a validation stream
    beside the training one; the stateful stage fits on the training
    stream, as in the reference."""
    t, td = env["topics"], env["td"]
    jl, tl = _ltr_pair(epochs=10, lr=0.1)
    jp, tp = _features(J, 30) >> jl, _features(T, 30) >> tl
    from repro.core.compiler import fit_pipeline as jfit
    jfit(jp, jax_queries(t), t.qrels, jax_queries(td), td.qrels,
         backend=env["jbe"])
    assert fit_pipeline(tp, torch_queries(t), t.qrels, torch_queries(td),
                        td.qrels, backend=env["tbe"]) is tp
    _assert_state_close(jl, tl)
    # a stateless pipeline fits to itself and changes nothing
    plain = T.Retrieve("BM25") % 10
    assert plain.fit(torch_queries(t), t.qrels, backend=env["tbe"]) is plain


@pytest.mark.parametrize("n,k,seed", [(10, 5, 1), (250, 2, 0), (250, 5, 0),
                                      (37, 4, 9)])
def test_kfold_splits_identical(n, k, seed):
    qids = np.arange(n)
    ref = list(jtuning.kfold_splits(qids, k, seed))
    out = list(ttuning.kfold_splits(qids, k, seed))
    assert len(out) == len(ref) == k
    for (a, b), (c, d) in zip(out, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_grid_search_table_and_best_params(env):
    """An RM3 grid over a shared first pass: the table and best params as
    the reference's, and the shared prefix (a counting probe) runs once
    across the grid."""
    t = env["topics"]
    calls = {"n": 0}

    def counting(Q, R):
        calls["n"] += 1
        return Q, R

    def build(M, probe=None):
        base = M.Retrieve("BM25")
        if probe is not None:
            base = base >> probe

        def make(fb_terms, fb_docs):
            return (base >> M.RM3Expand(fb_docs=fb_docs, fb_terms=fb_terms)
                    >> M.Retrieve("BM25"))
        return make

    grid = {"fb_terms": [3, 8], "fb_docs": [2, 5]}
    ref = jtuning.GridSearch(build(J), grid, jax_queries(t), t.qrels,
                             metric="map", backend=env["jbe"])
    out = T.GridSearch(build(T, Generic(fn=counting)), grid,
                       torch_queries(t), t.qrels, metric="map",
                       backend=env["tbe"])
    assert calls["n"] == 1
    assert out["best_params"] == ref["best_params"]
    assert len(out["table"]) == len(ref["table"]) == 4
    for a, b in zip(out["table"], ref["table"]):
        assert {k: a[k] for k in grid} == {k: b[k] for k in grid}
        assert abs(a["map"] - b["map"]) <= MEASURE_ATOL, (a, b)
    assert abs(out["best_score"] - ref["best_score"]) <= MEASURE_ATOL


def test_cross_validate_ltr(env):
    """Two folds, a fresh LTR pipeline a fold (each starting from the JAX
    stage's draw), 5 epochs: per-fold and mean measures as the
    reference's."""
    t = env["topics"]

    def build_j():
        return _features(J, 20) >> J.LTRRerank(n_features=3, epochs=5)

    def build_t():
        jl, tl = _ltr_pair(epochs=5)
        return _features(T, 20) >> tl

    metrics = ["map", "ndcg_cut_10"]
    ref = jtuning.CrossValidate(build_j, jax_queries(t), t.qrels, k=2,
                                metrics=metrics, backend=env["jbe"])
    out = T.CrossValidate(build_t, torch_queries(t), t.qrels, k=2,
                          metrics=metrics, backend=env["tbe"])
    assert len(out["folds"]) == 2
    for a, b in zip(out["folds"] + [out["mean"]], ref["folds"] + [ref["mean"]]):
        for m in metrics:
            assert abs(a[m] - b[m]) <= MEASURE_ATOL, (m, a, b)


def test_subset_indexes_on_the_tensors_device(env):
    Q = torch_queries(env["topics"])
    sub = ttuning._subset(Q, np.array([3, 1]))
    assert sub["qid"].tolist() == [3, 1]
    assert all(v.device == Q["qid"].device for v in sub.values())
    assert set(ttuning._subset_qrels(env["topics"].qrels, sub)) == {1, 3}
