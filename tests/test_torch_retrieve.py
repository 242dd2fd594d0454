"""Every ported retrieval op of ``index/retrieve.py`` against its JAX
counterpart (vmapped over queries) on the test topics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compiler import JaxBackend
from repro.index import retrieve as JRT
from repro.index.inverted import build_index as jbuild
from repro_torch.core.compiler import TorchBackend
from repro_torch.index import retrieve as TRT
from repro_torch.index.inverted import build_index as tbuild

from torch_parity import (ATOL, RTOL, assert_ranking_parity, jax_queries,
                          small_env, torch_queries)


@pytest.fixture(scope="module")
def env():
    corpus, topics, topics_td = small_env()
    jidx = jbuild(corpus)
    tidx = tbuild(corpus, device="cpu")
    jbe = JaxBackend(jidx, default_k=60, query_chunk=4, sharded=False)
    tbe = TorchBackend(tidx, default_k=60, query_chunk=4, device="cpu")
    assert tbe.max_postings == jbe.max_postings
    assert tbe.max_blocks_per_term == jbe.max_blocks_per_term
    assert tbe.total_blocks == jbe.total_blocks
    forms = {}
    for name, t in (("T", topics), ("TD", topics_td)):
        jq, tq = jax_queries(t), torch_queries(t)
        forms[name] = ((jq["terms"], jq["weights"]),
                       (tq["terms"], tq["weights"]))
    return {"jidx": jidx, "tidx": tidx, "mp": jbe.max_postings,
            "mbt": jbe.max_blocks_per_term, "forms": forms}


def _jax(fn, env, form, *extra, **kw):
    (jt, jw), _ = env["forms"][form]
    return jax.vmap(lambda *a: fn(env["jidx"], *a, **kw))(jt, jw, *extra)


def _torch(fn, env, form, *extra, **kw):
    _, (tt, tw) = env["forms"][form]
    return fn(env["tidx"], tt, tw, *extra, **kw)


@pytest.mark.parametrize("form", ["T", "TD"])
@pytest.mark.parametrize("model", ["BM25", "QL", "DPH"])
def test_score_exhaustive(env, form, model):
    kw = dict(model=model, max_postings=env["mp"])
    ref = _jax(JRT.score_exhaustive, env, form, **kw)
    out = _torch(TRT.score_exhaustive, env, form, **kw)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("form", ["T", "TD"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("model,k", [("BM25", 10), ("TF_IDF", 60),
                                     ("QL", 200)])
def test_retrieve_topk(env, form, fused, model, k):
    kw = dict(model=model, k=k, max_postings=env["mp"])
    jfn = JRT.retrieve_topk_fused if fused else JRT.retrieve_topk
    tfn = TRT.retrieve_topk_fused if fused else TRT.retrieve_topk
    jd, js = _jax(jfn, env, form, **kw)
    td, ts = _torch(tfn, env, form, **kw)
    assert td.dtype == torch.int32
    assert_ranking_parity(jd, js, td, ts, what=f"topk {model} {form}")


@pytest.mark.parametrize("form", ["T", "TD"])
@pytest.mark.parametrize("model,k", [("BM25", 10), ("QL", 100)])
def test_retrieve_pruned(env, form, model, k):
    assert TRT.block_budget(k, 8) == JRT.block_budget(k, 8)
    kw = dict(model=model, k=k, n_blocks=TRT.block_budget(k, 8),
              max_blocks_per_term=env["mbt"])
    jd, js = _jax(JRT.retrieve_pruned, env, form, **kw)
    td, ts = _torch(TRT.retrieve_pruned, env, form, **kw)
    finite = np.isfinite(np.asarray(js))
    np.testing.assert_array_equal(np.isfinite(ts.numpy()), finite)
    assert_ranking_parity(np.where(finite, jd, -1),
                          np.where(finite, js, 0.0),
                          np.where(finite, td.numpy(), -1),
                          np.where(finite, ts.numpy(), 0.0),
                          what=f"pruned {model} {form}")


@pytest.mark.parametrize("form", ["T", "TD"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("models,k", [(("BM25", "QL", "TF_IDF"), 20),
                                      (("DPH", "BM25", "Coord"), 60)])
def test_retrieve_fat(env, form, fused, models, k):
    kw = dict(rank_model=models[0], feature_models=models[1:], k=k,
              max_postings=env["mp"])
    jfn = JRT.retrieve_fat_fused if fused else JRT.retrieve_fat
    tfn = TRT.retrieve_fat_fused if fused else TRT.retrieve_fat
    jd, js, jf = _jax(jfn, env, form, **kw)
    td, ts, tf = _torch(tfn, env, form, **kw)
    ties = assert_ranking_parity(jd, js, td, ts, what=f"fat {models} {form}")
    assert tf.shape == jf.shape
    same = np.asarray(jd) == td.numpy()
    np.testing.assert_allclose(tf.numpy()[same], np.asarray(jf)[same],
                               rtol=RTOL, atol=ATOL)
    assert same.sum() == same.size - len(ties)


@pytest.mark.parametrize("form", ["T", "TD"])
@pytest.mark.parametrize("model", ["QL", "TF_IDF", "DPH", "BM25"])
def test_extract_feature_docvectors(env, form, model):
    jd, _ = _jax(JRT.retrieve_topk, env, form, model="BM25", k=60,
                 max_postings=env["mp"])
    docids = np.asarray(jd).copy()
    docids[:, -5:] = -1                       # padded candidates score 0
    kw = dict(model=model, max_fwd=env["jidx"].max_fwd_len)
    ref = _jax(JRT.extract_feature_docvectors, env, form, jnp.asarray(docids),
               **kw)
    out = _torch(TRT.extract_feature_docvectors, env, form,
                 torch.from_numpy(docids), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert (out.numpy()[:, -5:] == 0).all()
