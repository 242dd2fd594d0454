"""The port's dense- and PQ-scoring plain versions and wrappers against the
JAX package's Pallas kernels (interpret mode) and ``ref.py``s, at the
parameter sweeps and tolerances of ``tests/test_kernels.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dense_scoring.ops import \
    streaming_dense_topk as jax_streaming_dense_topk
from repro.kernels.dense_scoring.ref import dense_topk_ref as jax_dense_ref
from repro.kernels.pq_scoring.ops import \
    streaming_pq_topk as jax_streaming_pq_topk
from repro.kernels.pq_scoring.ref import pq_topk_ref as jax_pq_ref
from repro_torch.kernels.dense_scoring.ops import streaming_dense_topk
from repro_torch.kernels.dense_scoring.ref import dense_topk_ref
from repro_torch.kernels.pq_scoring.ops import streaming_pq_topk
from repro_torch.kernels.pq_scoring.ref import adc_scores, pq_topk_ref
from repro_torch.kernels.segments import plan_segments
from repro_torch.kernels.topk.ops import streaming_topk
from repro_torch.kernels.topk.ref import streaming_topk_ref

#: the tests/test_kernels.py tolerance of both kernels against their refs
TOL = 1e-5
NEG = -3.0e38


@pytest.mark.parametrize("n,dim,k,block,with_base",
                         [(2048, 64, 10, 1024, False),
                          (5000, 64, 32, 1024, True),
                          (700, 32, 16, 512, True),
                          (4096, 128, 128, 2048, False)])
def test_plain_dense_topk_matches_pallas_and_ref(n, dim, k, block,
                                                 with_base):
    rng = np.random.default_rng(n + k)
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    q = rng.standard_normal(dim).astype(np.float32)
    base = rng.standard_normal(n).astype(np.float32) if with_base else None
    jb = None if base is None else jnp.asarray(base)
    v1, i1 = jax_streaming_dense_topk(jnp.asarray(emb), jnp.asarray(q), jb,
                                      k=k, block=block, impl="pallas",
                                      interpret=True)
    v2, i2 = jax_dense_ref(jnp.asarray(emb), jnp.asarray(q), jb, k=k)
    tb = None if base is None else torch.from_numpy(base)[None]
    for fn in (dense_topk_ref, streaming_dense_topk):
        v3, i3 = fn(torch.from_numpy(emb), torch.from_numpy(q)[None], tb,
                    k=k)
        assert v3.shape == (1, k) and i3.dtype == torch.int32
        for v, i in ((v1, i1), (v2, i2)):
            np.testing.assert_allclose(v3[0].numpy(), np.asarray(v),
                                       rtol=TOL, atol=TOL)
            assert set(i3[0].tolist()) == set(np.asarray(i).tolist())


@pytest.mark.parametrize("nq,n,dim,k", [(4, 700, 32, 16), (3, 2100, 64, 10),
                                        (16, 200, 64, 10)])
def test_plain_dense_topk_per_query_rows_matches_reference(nq, n, dim, k):
    """[NQ, N, dim] rows (IVF candidates, a rerank's candidates) with a
    NEG-masked base, against the JAX ref mapped over the queries."""
    rng = np.random.default_rng(nq * n)
    emb = rng.standard_normal((nq, n, dim)).astype(np.float32)
    q = rng.standard_normal((nq, dim)).astype(np.float32)
    base = np.where(rng.random((nq, n)) < 0.3, NEG,
                    rng.standard_normal((nq, n))).astype(np.float32)
    v1, i1 = jax.vmap(lambda e, qq, b: jax_dense_ref(e, qq, b, k=k))(
        jnp.asarray(emb), jnp.asarray(q), jnp.asarray(base))
    v2, i2 = streaming_dense_topk(torch.from_numpy(emb), torch.from_numpy(q),
                                  torch.from_numpy(base), k=k)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v1), rtol=TOL,
                               atol=TOL)
    for a, b in zip(i2.numpy(), np.asarray(i1)):
        assert set(a.tolist()) == set(b.tolist())
    assert (v2.numpy() > NEG / 2).all()       # masked rows never enter


def test_plain_dense_topk_shared_rows_equal_gathered_rows():
    """Shared [N, dim] rows give what the same rows copied per query do."""
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(rng.standard_normal((900, 64)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    a = dense_topk_ref(emb, q, k=25)
    b = dense_topk_ref(emb.expand(3, -1, -1), q, k=25)
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=TOL,
                               atol=TOL)
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("n,m,k,block,with_base",
                         [(2048, 8, 10, 512, False),
                          (5000, 8, 32, 512, True),
                          (700, 4, 16, 256, True),
                          (4096, 16, 128, 1024, False)])
def test_plain_pq_topk_matches_pallas_and_ref(n, m, k, block, with_base):
    rng = np.random.default_rng(n + m + k)
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    table = rng.standard_normal((m, 256)).astype(np.float32)
    base = rng.standard_normal(n).astype(np.float32) if with_base else None
    jb = None if base is None else jnp.asarray(base)
    v1, i1 = jax_streaming_pq_topk(jnp.asarray(codes), jnp.asarray(table),
                                   jb, k=k, block=block, impl="pallas",
                                   interpret=True)
    v2, i2 = jax_pq_ref(jnp.asarray(codes), jnp.asarray(table), jb, k=k)
    tb = None if base is None else torch.from_numpy(base)[None]
    for fn in (pq_topk_ref, streaming_pq_topk):
        v3, i3 = fn(torch.from_numpy(codes)[None],
                    torch.from_numpy(table)[None], tb, k=k)
        assert v3.shape == (1, k) and i3.dtype == torch.int32
        for v, i in ((v1, i1), (v2, i2)):
            np.testing.assert_allclose(v3[0].numpy(), np.asarray(v),
                                       rtol=TOL, atol=TOL)
            assert set(i3[0].tolist()) == set(np.asarray(i).tolist())


def test_plain_pq_topk_duplicate_codes():
    """Codes in {0, 1}: massive ties.  Values agree with the Pallas kernel;
    every index scores its value; the ties go to the lowest index (the
    stable order of the exact sums, which the kernel repeats)."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 2, (3000, 8)).astype(np.uint8)
    table = rng.standard_normal((8, 256)).astype(np.float32)
    v1, _ = jax_streaming_pq_topk(jnp.asarray(codes), jnp.asarray(table),
                                  None, k=16, block=512, impl="pallas",
                                  interpret=True)
    v2, i2 = pq_topk_ref(torch.from_numpy(codes)[None],
                         torch.from_numpy(table)[None], k=16)
    np.testing.assert_allclose(v2[0].numpy(), np.asarray(v1), rtol=TOL,
                               atol=TOL)
    full = adc_scores(torch.from_numpy(codes)[None],
                      torch.from_numpy(table)[None])[0].numpy()
    np.testing.assert_array_equal(full[i2[0].numpy()], v2[0].numpy())
    want = np.argsort(-full, kind="stable")[:16]
    np.testing.assert_array_equal(i2[0].numpy(), want)


def test_plain_pq_adds_lookups_in_subspace_order_then_base():
    """The exact float order the kernel repeats: t_0 + t_1 + ... + t_{m-1},
    then + base, each add rounded to f32."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 256, (2, 300, 16)).astype(np.uint8)
    table = (rng.standard_normal((2, 16, 256)) * 1e3).astype(np.float32)
    base = rng.standard_normal((2, 300)).astype(np.float32)
    want = table[np.arange(2)[:, None], 0, codes[..., 0]]
    for s in range(1, 16):
        want = (want + table[np.arange(2)[:, None], s, codes[..., s]]
                ).astype(np.float32)
    want = (want + base).astype(np.float32)
    got = adc_scores(torch.from_numpy(codes), torch.from_numpy(table),
                     torch.from_numpy(base))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_row_sets,n,k,min_len",
                         [(1, 528155, 10, 4096), (1, 528155, 128, 1024),
                          (16, 40000, 80, 1024), (16, 200, 10, 1024),
                          (2, 3 * 2048 + 5, 128, 1024), (3, 130, 7, 4096)])
def test_segment_plan_and_padded_merge_give_the_topk(n_row_sets, n, k,
                                                     min_len):
    """The top-k and dense kernels' two-stage plan — each segment's
    top-min(k, len), padded to k with (-inf, INT_MAX), then a top-k of the
    segments' lists taken by position — gives the row's top-k with the
    lowest-index rule; the plain top-k stands in for both stages."""
    n_seg, seg_len = plan_segments(n_row_sets, n, k, 132, min_len=min_len,
                                   one_wave=True)
    assert (n_seg - 1) * seg_len < n <= n_seg * seg_len
    assert n_seg == 1 or seg_len >= max(k, min_len)
    assert n_row_sets * n_seg <= 2 * 132 or n_seg == 1
    rng = np.random.default_rng(n)
    row = torch.from_numpy(rng.integers(-30, 30, n).astype(np.float32))
    row[rng.random(n) < 0.01] = -torch.inf
    cand_v, cand_i = [], []
    for lo in range(0, n, seg_len):
        seg = row[lo:lo + seg_len]
        kk = min(k, seg.shape[0])
        v, i = streaming_topk_ref(seg, k=kk)
        cand_v.append(torch.cat([v, torch.full((k - kk,), -torch.inf)]))
        cand_i.append(torch.cat([i + lo, torch.full((k - kk,), 2**31 - 1,
                                                    dtype=torch.int32)]))
    v, pos = streaming_topk_ref(torch.cat(cand_v), k=k)
    want_v, want_i = streaming_topk_ref(row, k=k)
    assert torch.equal(v, want_v)
    assert torch.equal(torch.cat(cand_i)[pos.long()], want_i)


def test_cpu_path_launches_no_kernel():
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.standard_normal((500, 16)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (2, 500, 8)).astype(np.uint8))
    table = torch.from_numpy(rng.standard_normal((2, 8, 256)).astype(np.float32))
    for k in (10, 200):
        a = streaming_dense_topk(emb, q, k=k)
        b = dense_topk_ref(emb, q, k=k)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        a = streaming_pq_topk(codes, table, k=k)
        b = pq_topk_ref(codes, table, k=k)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert streaming_dense_topk.launches == 0
    assert streaming_pq_topk.launches == 0


def test_wrappers_reject_bad_arguments():
    emb, q = torch.zeros((20, 8)), torch.zeros((2, 8))
    with pytest.raises(ValueError):
        streaming_dense_topk(emb, q, k=21)
    with pytest.raises(ValueError):
        streaming_dense_topk(emb, torch.zeros((2, 4)), k=5)
    with pytest.raises(ValueError):
        streaming_dense_topk(emb, q, torch.zeros((2, 19)), k=5)
    with pytest.raises(ValueError):
        streaming_dense_topk(torch.zeros((3, 20, 8)), q, k=5)
    codes = torch.zeros((2, 20, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        streaming_pq_topk(codes, torch.zeros((2, 4, 256)), k=21)
    with pytest.raises(ValueError):
        streaming_pq_topk(codes.int(), torch.zeros((2, 4, 256)), k=5)
    with pytest.raises(ValueError):
        streaming_pq_topk(codes, torch.zeros((2, 3, 256)), k=5)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so a wrapper takes its
    kernel branch up to the point where it would launch."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("wrapper", ["topk", "dense_topk", "pq_topk"])
def test_wrappers_raise_past_kernel_k_on_card_tensors(wrapper):
    """On the card a wrapper launches its kernel or raises: a k past the
    kernel's 128 never goes quietly to the plain version."""
    calls = {
        "topk": (streaming_topk, torch.zeros((2, 300))),
        "dense_topk": (streaming_dense_topk, torch.zeros((300, 8)),
                       torch.zeros((2, 8))),
        "pq_topk": (streaming_pq_topk,
                    torch.zeros((2, 300, 4), dtype=torch.uint8),
                    torch.zeros((2, 4, 256)))}
    fn, first, *rest = calls[wrapper]
    with pytest.raises(ValueError, match="serves k <= 128"):
        fn(first.as_subclass(_OnCard), *rest, k=129)
    assert streaming_topk.launches == 0
    assert streaming_dense_topk.launches == 0
    assert streaming_pq_topk.launches == 0
