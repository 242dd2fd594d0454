"""The port's attention (``kernels/flash_attention``, ``models/layers.py``)
against the JAX package on the CPU.

The flash kernel's plain version is held against ``flash_attention_pallas``
in interpret mode and against ``flash_attention_ref`` at the contract of
``tests/test_kernels.py``: atol 2e-6 in float32, 2e-2 in bfloat16.  The
layers take the same numpy inputs on both sides.  On the CPU the wrapper
takes the plain version; the kernel itself is held against it on the card
by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as jref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import layers as TL

TOL = {"float32": 2e-6, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(seed, B, S, T, H, HKV, D, dtype):
    """The same inputs for both packages, drawn with numpy and rounded to
    ``dtype`` once (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, T, HKV, D), (B, T, HKV, D))]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.tensor(a).to(td) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,HKV,D,bq,bkv",
                         [(1, 128, 2, 2, 64, 64, 64),     # MHA
                          (2, 256, 4, 2, 64, 128, 64),    # GQA
                          (1, 256, 8, 1, 128, 64, 128)])  # MQA
def test_flash_plain_matches_pallas_sweep(dtype, B, S, H, HKV, D, bq, bkv):
    (jq, jk, jv), (tq, tk, tv) = _qkv(S + H, B, S, S, H, HKV, D, dtype)
    want = _f32(flash_attention_pallas(jq, jk, jv, causal=True, bq=bq,
                                       bkv=bkv, interpret=True))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), want, atol=TOL[dtype])
    np.testing.assert_allclose(
        _f32(got), _f32(jref(jq, jk, jv, causal=True)), atol=TOL[dtype])


@pytest.mark.parametrize("chunk", [32, 128])
def test_flash_plain_matches_pallas_chunked(chunk):
    (jq, jk, jv), (tq, tk, tv) = _qkv(chunk, 1, 256, 256, 4, 2, 64,
                                      "float32")
    want = _f32(flash_attention_pallas(jq, jk, jv, causal=True, chunk=chunk,
                                       bq=64, bkv=64, interpret=True))
    got = flash_attention(tq, tk, tv, causal=True, chunk=chunk)
    np.testing.assert_allclose(_f32(got), want, atol=2e-6)


@pytest.mark.parametrize("S,T,causal,chunk",
                         [(1, 1, True, 0), (1, 70, False, 0),
                          (70, 70, True, 0), (100, 100, True, 32),
                          (37, 131, False, 0), (100, 70, True, 32),
                          (130, 70, False, 48)])
def test_flash_plain_matches_reference_ragged(S, T, causal, chunk):
    """S and T that no 64-row tile divides (the Pallas kernel asks them to
    divide its blocks; the port's kernel masks the ragged tails), and T < S
    with rows whose chunk holds no key (the reference averages all T)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(S * T, 2, S, T, 4, 2, 64, "float32")
    want = _f32(jref(jq, jk, jv, causal=causal, chunk=chunk))
    got = flash_attention(tq, tk, tv, causal=causal, chunk=chunk)
    np.testing.assert_allclose(_f32(got), want, atol=2e-6)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so the wrapper takes
    its kernel branch up to the point where it would launch."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("D,dtype,match", [
    (48, torch.float32, "d_head=48"),
    (96, torch.bfloat16, "d_head=96"),
    (64, torch.float16, "dtypes")])
def test_wrapper_raises_on_card_for_what_the_kernel_does_not_take(D, dtype,
                                                                  match):
    q = torch.zeros((1, 8, 2, D), dtype=dtype)
    k = torch.zeros((1, 8, 1, D), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        flash_attention(q.as_subclass(_OnCard), k, k)
    assert flash_attention.launches == 0


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_wrapper_raises_on_card_for_misaligned_bf16(which):
    """The bf16 kernel reads q, k, v through TMA tensor maps, which need
    each base pointer on a 16-byte boundary: a contiguous view that starts
    one element into its storage raises before any launch."""
    shapes = {"q": (1, 8, 2, 64), "k": (1, 8, 1, 64), "v": (1, 8, 1, 64)}
    t = {}
    for name, shape in shapes.items():
        off = int(name == which)
        flat = torch.zeros(off + int(np.prod(shape)), dtype=torch.bfloat16)
        t[name] = flat[off:].view(shape).as_subclass(_OnCard)
    assert t[which].data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention(t["q"], t["k"], t["v"])
    assert flash_attention.launches == 0


def test_wrapper_rejects_bad_shapes():
    q, k = torch.zeros((1, 8, 3, 64)), torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="H % Hkv"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros((1, 8, 2, 64)), k, torch.zeros((1, 9, 2,
                                                                    64)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    g = rng.standard_normal(48).astype(np.float32)
    for jd, td in DTYPES.values():
        want = _f32(JL.rmsnorm(jnp.asarray(x, jd), jnp.asarray(g), 1e-6))
        got = TL.rmsnorm(torch.tensor(x).to(td), torch.tensor(g), 1e-6)
        assert got.dtype == td
        # bf16: one rounding of the fp32 result, which may land either side
        tol = 1e-6 if td == torch.float32 else 2e-2
        np.testing.assert_allclose(_f32(got), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.arange(1000, 1040, dtype=np.int32)
    np.testing.assert_allclose(
        TL.rope_frequencies(16, theta).numpy(),
        np.asarray(JL.rope_frequencies(16, theta)), rtol=1e-6)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = TL.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    # angles of ~1000 rad: the two libraries reduce them differently
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("causal,chunk,valid", [
    (True, 0, None), (False, 0, None), (True, 4, None), (True, 0, 7),
    (True, 4, [5, 9])])
def test_attention_bias_matches_reference(causal, chunk, valid):
    qp, kp = np.arange(3, 9, dtype=np.int32), np.arange(12, dtype=np.int32)
    want = np.asarray(JL.attention_bias(
        jnp.asarray(qp), jnp.asarray(kp), causal=causal, chunk=chunk,
        kv_valid_len=None if valid is None else jnp.asarray(valid)))
    got = TL.attention_bias(torch.tensor(qp), torch.tensor(kp), causal=causal,
                            chunk=chunk, kv_valid_len=valid)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T", [(6, 6), (1, 20), (2048, 2048)])
def test_gqa_attention_einsum_path_matches_reference(dtype, S, T):
    """impl="xla" over a decode-style bias (cache slots past the valid
    length masked); S = 2048 takes the q-chunked loop of both packages."""
    B, H, HKV, D = (1, 2, 1, 8) if S > 1000 else (2, 4, 2, 16)
    (jq, jk, jv), (tq, tk, tv) = _qkv(S + T, B, S, T, H, HKV, D, dtype)
    qp = np.arange(T - S, T, dtype=np.int32)
    kp = np.arange(T, dtype=np.int32)
    jb = JL.attention_bias(jnp.asarray(qp), jnp.asarray(kp), causal=True,
                           chunk=0, kv_valid_len=T - 1)[:, None, None]
    tb = TL.attention_bias(torch.tensor(qp), torch.tensor(kp), causal=True,
                           chunk=0, kv_valid_len=T - 1)[:, None, None]
    want = _f32(JL.gqa_attention(jq, jk, jv, jb, impl="xla"))
    got = TL.gqa_attention(tq, tk, tv, tb, impl="xla")
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_f32(got), want, atol=TOL[dtype])


def test_gqa_attention_pallas_path_is_the_flash_wrapper():
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 1, 64, 64, 4, 2, 64, "float32")
    want = _f32(JL.gqa_attention(jq, jk, jv, None, impl="pallas"))
    got = TL.gqa_attention(tq, tk, tv, None, impl="pallas")
    np.testing.assert_allclose(_f32(got), want, atol=2e-6)
    flash = TL.gqa_attention(tq, tk, tv, None, impl="flash")
    np.testing.assert_allclose(_f32(flash), want, atol=2e-6)
    with pytest.raises(ValueError, match="unknown attention impl"):
        TL.gqa_attention(tq, tk, tv, None, impl="ref")


def _attn_pair(seed):
    """One attention layer's weights (QKV bias on) on both sides."""
    import jax
    dims = JL.AttnDims(d_model=32, n_q=4, n_kv=2, d_head=8, qkv_bias=True,
                       rope_theta=1e4)
    jp = JL.attn_init(jax.random.key(seed), dims, jnp.float32)
    rng = np.random.default_rng(seed + 5)
    jp = {**jp, **{b: jnp.asarray(rng.standard_normal(jp[b].shape),
                                  jnp.float32) for b in ("bq", "bk", "bv")}}
    tp = TL.Attention(TL.AttnDims(**vars(dims)), torch.float32, "cpu")
    with torch.no_grad():
        for name, a in jp.items():
            getattr(tp, name).copy_(torch.tensor(np.asarray(a)))
    return dims, jp, tp, rng


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("cached,start,S", [(False, 3, 5), (True, 3, 5),
                                            (True, 0, 5), (True, 4, 1)])
def test_attn_apply_matches_reference(cached, start, S, impl):
    """Projections, QKV bias, RoPE and the core; with a cache, the fresh k/v
    written at the offset and the slots past them masked.  The reference is
    the JAX einsum path: "pallas" takes the kernel only without a cache or
    for a prefill at offset 0, and the einsum path over the cache at any
    other offset.  A memo shared by two calls (two layers) changes
    nothing."""
    dims, jp, tp, rng = _attn_pair(0)
    B, T = 2, 12
    x = rng.standard_normal((B, S, 32)).astype(np.float32)
    pos = np.arange(start, start + S, dtype=np.int32)
    jkw, tkw = {}, {}
    if cached:
        c = rng.standard_normal((B, T, 2, 8)).astype(np.float32)
        jkw = dict(kv_cache=(jnp.asarray(c), jnp.asarray(c)),
                   cache_index=start)
        tc = (torch.tensor(c), torch.tensor(c))
        tkw = dict(kv_cache=tc, cache_index=start)
    want = JL.attn_apply(jp, jnp.asarray(x), dims, positions=jnp.asarray(pos),
                         impl="xla", **jkw)
    memo = {}
    for _ in range(2):
        got = TL.attn_apply(tp, torch.tensor(x), positions=torch.tensor(pos),
                            impl=impl, memo=memo, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
    assert "rope" in memo
    if cached:
        np.testing.assert_allclose(tc[0].numpy(), np.asarray(want[1][0]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cached", [False, True])
def test_attn_apply_kernel_path_takes_plain_causal_only(cached):
    """The kernel path takes a chunk and non-causal masks as the einsum path
    does (chunked-local attention on the kernel is ported; the JAX
    package's "pallas" path drops the chunk, so the reference is its "xla"
    path), with or without a prefill cache; so does ``impl="flash"`` (the
    training path, ``flash_attention_xla``)."""
    dims, jp, tp, rng = _attn_pair(1)
    x = rng.standard_normal((2, 11, 32)).astype(np.float32)
    pos = np.arange(11, dtype=np.int32)
    for kw in (dict(chunk=4), dict(causal=False), dict(chunk=3,
                                                       causal=False)):
        jkw, tkw = {}, {}
        if cached:
            c = np.zeros((2, 16, 2, 8), np.float32)
            jkw = dict(kv_cache=(jnp.asarray(c), jnp.asarray(c)),
                       cache_index=0)
            tkw = dict(kv_cache=(torch.tensor(c), torch.tensor(c)),
                       cache_index=0)
        want = JL.attn_apply(jp, jnp.asarray(x), dims,
                             positions=jnp.asarray(pos), impl="xla", **jkw,
                             **kw)
        for impl in ("pallas", "flash"):
            got = TL.attn_apply(tp, torch.tensor(x),
                                positions=torch.tensor(pos), impl=impl,
                                **tkw, **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want[0]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{impl} {kw}")
