"""The port's kernel wrappers and plain versions against the Pallas kernels
(interpret mode) and ``lax.top_k``; the build's refusals without nvcc."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_scoring.ops import fused_scoring as jax_fused_scoring
from repro.kernels.topk.ops import streaming_topk as jax_streaming_topk
from repro_torch.kernels import _build
from repro_torch.kernels.fused_scoring.ops import fused_scoring
from repro_torch.kernels.fused_scoring.ref import fused_scoring_ref
from repro_torch.kernels.topk.ops import streaming_topk
from repro_torch.kernels.topk.ref import streaming_topk_ref

STATS = {"n_docs": 8000.0, "avg_doclen": 200.0, "total_terms": 1.6e6}


@pytest.mark.parametrize("n,k,block", [(4096, 10, 1024), (8192, 32, 2048),
                                       (4096, 128, 4096), (20000, 7, 1024)])
def test_plain_topk_matches_pallas_and_lax(n, k, block):
    rng = np.random.default_rng(n + k)
    s = rng.standard_normal(n).astype(np.float32)
    v1, i1 = jax_streaming_topk(jnp.asarray(s), k=k, block=block,
                                impl="pallas", interpret=True)
    v2, i2 = jax.lax.top_k(jnp.asarray(s), k)
    v3, i3 = streaming_topk_ref(torch.from_numpy(s), k=k)
    np.testing.assert_array_equal(v3.numpy(), np.asarray(v2))
    np.testing.assert_array_equal(i3.numpy(), np.asarray(i2))
    np.testing.assert_allclose(v3.numpy(), np.asarray(v1), rtol=1e-6)
    assert set(i3.numpy().tolist()) == set(np.asarray(i1).tolist())


@pytest.mark.parametrize("k", [1, 10, 64, 128, 300])
def test_plain_topk_ties_go_to_lowest_index(k):
    rng = np.random.default_rng(k)
    s = rng.integers(0, 6, (3, 5000)).astype(np.float32)
    v_ref, i_ref = jax.vmap(lambda r: jax.lax.top_k(r, k))(jnp.asarray(s))
    vals, idxs = streaming_topk(torch.from_numpy(s), k=k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(i_ref))
    assert idxs.dtype == torch.int32


@pytest.mark.parametrize("n", [512, 2048, 5000])
@pytest.mark.parametrize("models", [("BM25",), ("BM25", "QL", "TF_IDF"),
                                    ("BM25", "TF_IDF", "QL", "DPH", "Coord")])
def test_plain_fused_scoring_matches_pallas(n, models):
    rng = np.random.default_rng(n)
    cols = [rng.integers(0, 30, n), rng.integers(20, 800, n),
            rng.integers(1, 4000, n), rng.integers(1, 30000, n)]
    cols = [c.astype(np.int32) for c in cols]
    a = jax_fused_scoring(*map(jnp.asarray, cols), models=models, stats=STATS,
                          impl="pallas", interpret=True)
    b = fused_scoring(*map(torch.from_numpy, cols), models=models,
                      stats=STATS)
    assert b.shape == (n, len(models)) and b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("models", [("BM25", "QL", "TF_IDF"),
                                    ("BM25", "TF_IDF", "QL", "DPH", "Coord")])
def test_fused_scoring_takes_term_stats_once_per_posting_list(models):
    """df/cf given once per row of postings ([..., 1]) score as the same
    values copied out to every posting do, through the Pallas kernel."""
    rng = np.random.default_rng(3)
    tf = rng.integers(0, 30, (2, 3, 512)).astype(np.int32)
    dl = rng.integers(20, 800, (2, 3, 512)).astype(np.int32)
    df = rng.integers(1, 4000, (2, 3, 1)).astype(np.int32)
    cf = rng.integers(1, 30000, (2, 3, 1)).astype(np.int64)
    flat = [x.reshape(-1) for x in
            (tf, dl, np.broadcast_to(df, tf.shape),
             np.broadcast_to(cf, tf.shape).astype(np.int32))]
    a = jax_fused_scoring(*map(jnp.asarray, flat), models=models, stats=STATS,
                          impl="pallas", interpret=True)
    b = fused_scoring(*map(torch.from_numpy, (tf, dl, df, cf)), models=models,
                      stats=STATS)
    assert b.shape == (*tf.shape, len(models))
    np.testing.assert_allclose(b.reshape(-1, len(models)).numpy(),
                               np.asarray(a), rtol=2e-5, atol=1e-5)
    with pytest.raises(ValueError, match="share a shape"):
        fused_scoring(*map(torch.from_numpy, (tf, dl, df[..., :1, :], cf)),
                      models=models, stats=STATS)


def test_cpu_path_launches_no_kernel():
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))
    streaming_topk(s, k=10)
    streaming_topk(s, k=200)
    cols = [torch.from_numpy(rng.integers(1, 50, 1000).astype(np.int32))
            for _ in range(4)]
    ref = fused_scoring_ref(*cols, models=("BM25", "DPH"), n_docs=8000.0,
                            avg_dl=200.0, total_terms=1.6e6)
    out = fused_scoring(*cols, models=("BM25", "DPH"), stats=STATS)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert streaming_topk.launches == 0
    assert fused_scoring.launches == 0


def test_wrappers_reject_bad_arguments():
    s = torch.zeros((2, 16))
    with pytest.raises(ValueError):
        streaming_topk(s, k=17)
    with pytest.raises(ValueError):
        fused_scoring(*(torch.ones(4, dtype=torch.int32),) * 4,
                      models=("BM25", "SDM"), stats=STATS)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_failed_compile_raises_with_compiler_output():
    bad = [sys.executable, "-c", "import sys; print('bad kernel'); sys.exit(3)"]
    with pytest.raises(RuntimeError, match="(?s)exit 3.*bad kernel"):
        _build._run_all([[sys.executable, "-c", "pass"], bad])


@pytest.mark.parametrize("nq,n,k", [(16, 528155, 10), (1, 528155, 128),
                                    (250, 70001, 10), (3, 1000, 128),
                                    (4, 9000, 128), (2, 130, 7),
                                    (16, 2 * 4096 + 100, 128)])
def test_segment_plan_covers_rows_and_merges_to_topk(nq, n, k):
    """The kernel's two-stage plan — each segment's top-min(k, len),
    padded to k with (-inf, INT_MAX), then a top-k of the segments' lists
    taken by position — gives the row's top-k with the lowest-index tie
    rule; here with the plain top-k standing in for both stages."""
    from repro_torch.kernels.topk.ops import MIN_SEGMENT, plan
    s, seg = plan(nq, n, k, 132)
    assert 1 <= s and (s - 1) * seg < n <= s * seg
    assert s == 1 or seg >= max(k, MIN_SEGMENT)
    assert s == 1 or nq * s >= 132 or n // s < 2 * MIN_SEGMENT
    assert nq * s <= max(nq, 2 * 132)         # one wave of two blocks an SM
    rng = np.random.default_rng(n)
    row = torch.from_numpy(rng.integers(0, 40, n).astype(np.float32))
    cand_v, cand_i = [], []
    for lo in range(0, n, seg):
        kk = min(k, n - lo)
        v, i = streaming_topk_ref(row[lo:lo + seg], k=kk)
        cand_v.append(torch.cat([v, torch.full((k - kk,), -torch.inf)]))
        cand_i.append(torch.cat([i + lo, torch.full((k - kk,), 2**31 - 1,
                                                    dtype=torch.int32)]))
    v, pos = streaming_topk_ref(torch.cat(cand_v), k=k)
    want_v, want_i = streaming_topk_ref(row, k=k)
    assert torch.equal(v, want_v)
    assert torch.equal(torch.cat(cand_i)[pos.long()], want_i)
