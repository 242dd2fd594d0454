"""Corpus, index and weighting models of the port against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import inverted as jinv
from repro.index import scoring as jscoring
from repro.index.corpus import expand_topics as jexpand
from repro.index.corpus import synthesize_corpus as jcorpus
from repro.index.corpus import synthesize_topics as jtopics
from repro_torch.index import corpus as tcorpus
from repro_torch.index import inverted as tinv
from repro_torch.index import scoring as tscoring

from torch_parity import ATOL, RTOL


@pytest.fixture(scope="module")
def env():
    jc = jcorpus(n_docs=3000, vocab=12000, mean_len=100, seed=7)
    jt = jtopics(jc, n_topics=8, q_len=3, rels_per_topic=12, seed=8)
    tc = tcorpus.synthesize_corpus(n_docs=3000, vocab=12000, mean_len=100,
                                   seed=7)
    tt = tcorpus.synthesize_topics(tc, n_topics=8, q_len=3, rels_per_topic=12,
                                   seed=8)
    return {"jc": jc, "jt": jt, "tc": tc, "tt": tt,
            "jidx": jinv.build_index(jc),
            "tidx": tinv.build_index(tc, device="cpu")}


def test_corpus_and_topics_equal(env):
    jc, tc, jt, tt = env["jc"], env["tc"], env["jt"], env["tt"]
    np.testing.assert_array_equal(tc.doc_terms, jc.doc_terms)
    np.testing.assert_array_equal(tc.doc_start, jc.doc_start)
    for a, b in [(tt, jt), (tcorpus.expand_topics(tt, q_len=10, seed=9),
                            jexpand(jt, q_len=10, seed=9))]:
        np.testing.assert_array_equal(a.qids, b.qids)
        np.testing.assert_array_equal(a.terms, b.terms)
        np.testing.assert_array_equal(a.weights, b.weights)
        assert a.qrels == b.qrels


def _assert_index_equal(tidx, jidx):
    for name in tinv.ARRAY_NAMES:
        np.testing.assert_array_equal(getattr(tidx, name).numpy(),
                                      np.asarray(getattr(jidx, name)),
                                      err_msg=name)
    assert tidx.stats == jidx.stats
    assert tidx.max_fwd_len == jidx.max_fwd_len


def test_index_arrays_and_stats_equal(env):
    tidx = env["tidx"]
    _assert_index_equal(tidx, env["jidx"])
    for name in ("term_start", "cf", "fwd_start"):
        assert getattr(tidx, name).dtype == torch.int64


def test_index_from_arrays_round_trips(env):
    jidx = env["jidx"]
    arrays = {n: np.asarray(getattr(jidx, n)) for n in tinv.ARRAY_NAMES}
    meta = {n: getattr(jidx, n) for n in tinv.META_NAMES}
    tidx = tinv.index_from_arrays(arrays, meta, "cpu")
    _assert_index_equal(tidx, jidx)
    for name, a in tidx.arrays().items():
        assert torch.equal(a, getattr(env["tidx"], name)), name


def test_gather_postings_batched_equals_vmap(env):
    topics = jexpand(env["jt"], q_len=10, seed=9)
    terms = np.pad(topics.terms, ((0, 0), (0, 16)), constant_values=-1)
    mp = 256
    ref = jax.vmap(lambda t: jinv.gather_postings(env["jidx"], t, mp))(
        jnp.asarray(terms))
    out = tinv.gather_postings(env["tidx"], torch.from_numpy(terms), mp)
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)


@pytest.mark.parametrize("model", ["BM25", "TF_IDF", "QL", "DPH", "Coord"])
def test_weighting_models_and_upper_bound_agree(env, model):
    rng = np.random.default_rng(len(model))
    n = 4000
    tf = rng.integers(0, 30, n).astype(np.int32)
    dl = rng.integers(20, 800, n).astype(np.int32)
    df = rng.integers(1, 4000, n).astype(np.int32)
    cf = rng.integers(1, 30000, n).astype(np.int32)
    stats = env["tidx"].stats
    a = jscoring.WEIGHTING_MODELS[model](*map(jnp.asarray, (tf, dl, df, cf)),
                                         stats)
    b = tscoring.WEIGHTING_MODELS[model](*map(torch.from_numpy,
                                              (tf, dl, df, cf)), stats)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)
    jidx, tidx = env["jidx"], env["tidx"]
    blk = np.arange(0, int(jidx.block_max_tf.shape[0]), 7)
    term = rng.integers(0, jidx.vocab, blk.shape[0])
    ub_j = jscoring.upper_bound(
        model, jidx.block_max_tf[blk], jidx.block_min_dl[blk],
        jidx.df[term], jidx.cf[term], jidx.stats)
    ub_t = tscoring.upper_bound(
        model, tidx.block_max_tf[blk], tidx.block_min_dl[blk],
        tidx.df[term], tidx.cf[term], tidx.stats)
    np.testing.assert_allclose(ub_t.numpy(), np.asarray(ub_j), rtol=RTOL,
                               atol=ATOL)
    both = tscoring.score_all(["BM25", model], *map(torch.from_numpy,
                                                    (tf, dl, df, cf)), stats)
    np.testing.assert_array_equal(both[:, 1].numpy(), b.numpy())
