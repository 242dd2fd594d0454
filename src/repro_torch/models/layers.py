"""Core neural layers of the LMs: RMSNorm, RoPE, GQA attention, gated MLP
(the port of ``src/repro/models/layers.py``).

Plain functions on tensors, and ``nn.Module``s for the parametrised parts
(attention and the gated MLP).  Parameters keep the JAX package's layouts
(wq [d_model, n_q, d_head], wo [n_q, d_head, d_model], w_gate [d_model,
d_ff], ...), so a weight tree carries across as it is, and its cast points:
rmsnorm and RoPE in fp32, attention scores in fp32, probabilities cast to
v's dtype before the PV product.  Attention takes one of two paths, by
``impl``, the JAX package's names kept:

* ``"xla"``    — the einsum formulation (an additive bias carries the masks);
* ``"pallas"`` — the flash-attention kernel (``kernels/flash_attention``),
                 causal over the fresh tokens; inference only (the kernel
                 has no backward);
* ``"flash"``  — ``flash_attention_xla``, the training path: the same
                 kernel forward under an ``autograd.Function`` whose
                 backward recomputes the scores in blocks of q rows.

Parameters are created with ``requires_grad=False``, which the serving
paths (CUDA-graph captures included) rely on; the trainer
(``train.train_step.init_state``) switches them on.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.common import DEFAULT_DTYPE, resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention, \
    flash_attention_xla

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, dtype=DEFAULT_DTYPE,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (±3 std) fan-in init, drawn in fp32 on the
    generator's device, then cast."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (t * std).to(dtype)


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# RMSNorm and RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32)).to(dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)          # [head_dim / 2]


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0):
    """The RoPE tables (cos, sin), each [..., S, 1, head_dim / 2] fp32."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, D/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, cos_sin=None) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].
    ``cos_sin`` passes tables :func:`rope_cos_sin` made already."""
    cos, sin = (cos_sin if cos_sin is not None
                else rope_cos_sin(positions, x.shape[-1], theta))
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention masks and the GQA core
# ---------------------------------------------------------------------------

def attention_bias(q_positions: torch.Tensor, k_positions: torch.Tensor, *,
                   causal: bool = True, chunk: int = 0,
                   kv_valid_len=None) -> torch.Tensor:
    """Additive fp32 bias [.., S, T]; -1e30 at masked positions.

    ``chunk > 0`` restricts attention to the same length-``chunk`` block
    (Llama-4 style chunked local attention).  ``kv_valid_len`` ([B] or an
    int) masks the KV-cache slots past the tokens written so far."""
    q = q_positions[:, None]
    k = k_positions[None, :]
    ok = torch.ones((q_positions.shape[0], k_positions.shape[0]),
                    dtype=torch.bool, device=q_positions.device)
    if causal:
        ok &= k <= q
    if chunk:
        ok &= (k // chunk) == (q // chunk)
    bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
    if kv_valid_len is not None:
        if not isinstance(kv_valid_len, int):
            kv_valid_len = torch.as_tensor(
                kv_valid_len, device=k.device).reshape(-1, 1, 1)
        valid = k_positions[None, None, :] < kv_valid_len
        bias = bias[None] + torch.where(valid, 0.0, NEG_INF)
    return bias


#: above this many query rows the einsum path runs blocks of q rows, so the
#: [S, T] score tensor never materialises whole (each row still sees all T)
Q_CHUNK = 1024
#: and halves the rows of a block until its fp32 scores [B, n_q, rows, T]
#: take at most this many bytes (a 16,384-token prompt's cache makes a
#: block of 1,024 rows 2.7 GB a sequence)
SCORE_BLOCK_BYTES = 1 << 31


def _attn_core(qg, k, v, bias):
    """qg [B, s, n_kv, G, D] vs k/v [B, T, n_kv, D]; bias [..., s, T]."""
    D = qg.shape[-1]
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32))
    while bias.dim() < scores.dim():
        bias = bias[None]
    # scaled and masked in place: two [.., s, T] fp32 tensors at the peak
    probs = torch.softmax(scores.mul_(D ** -0.5).add_(bias), dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias,
                  *, impl: str = "xla", q_chunk: int = Q_CHUNK):
    """Grouped-query attention, softmax in fp32.  q [B, S, n_q, D], k/v
    [B, T, n_kv, D]; bias broadcastable to [B, n_kv, G, S, T] from
    [.., S, T] (unused by ``impl="pallas"`` and ``"flash"``, whose masks
    are causal by construction).  Returns [B, S, n_q, D]."""
    if impl == "flash":
        return flash_attention_xla(q, k, v, causal=True)
    if impl == "pallas":
        return flash_attention(q, k, v, causal=True)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    B, S, n_q, D = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(B, S, n_kv, n_q // n_kv, D)
    while q_chunk > 1 and B * n_q * q_chunk * k.shape[1] * 4 > \
            SCORE_BLOCK_BYTES:
        q_chunk //= 2
    if S <= q_chunk or S % q_chunk:
        return _attn_core(qg, k, v, bias).reshape(B, S, n_q, D)
    outs = [_attn_core(qg[:, i:i + q_chunk], k, v,
                       bias[..., i:i + q_chunk, :])
            for i in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, S, n_q, D)


# ---------------------------------------------------------------------------
# attention block (projections + rope + core)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, kw_only=True)
class AttnDims:
    d_model: int
    n_q: int
    n_kv: int
    d_head: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0


class Attention(nn.Module):
    """The attention projections: wq/wk/wv [d_model, heads, d_head], wo
    [n_q, d_head, d_model], and bq/bk/bv [heads, d_head] with
    ``qkv_bias``; on ``device`` (``None`` = the card)."""

    def __init__(self, dims: AttnDims, dtype=DEFAULT_DTYPE, device=None):
        super().__init__()
        self.dims = dims
        d, h = dims.d_model, dims.d_head
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.wq = _param(d, dims.n_q, h, **kw)
        self.wk = _param(d, dims.n_kv, h, **kw)
        self.wv = _param(d, dims.n_kv, h, **kw)
        self.wo = _param(dims.n_q, h, d, **kw)
        if dims.qkv_bias:
            self.bq = _param(dims.n_q, h, **kw)
            self.bk = _param(dims.n_kv, h, **kw)
            self.bv = _param(dims.n_kv, h, **kw)

    def project(self, x: torch.Tensor, positions: torch.Tensor,
                cos_sin=None):
        """x [B, S, d] -> q [B, S, n_q, D], k and v [B, S, n_kv, D], RoPE
        applied to q and k (``cos_sin``: tables made already)."""
        B, S, d = x.shape
        dims = self.dims

        def proj(w):
            return (x @ w.reshape(d, -1)).reshape(B, S, w.shape[1],
                                                   dims.d_head)

        q, k, v = proj(self.wq), proj(self.wk), proj(self.wv)
        if dims.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        if cos_sin is None:
            cos_sin = rope_cos_sin(positions, dims.d_head, dims.rope_theta)
        return (apply_rope(q, positions, cos_sin=cos_sin),
                apply_rope(k, positions, cos_sin=cos_sin), v)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """[B, S, n_q, D] -> [B, S, d_model]."""
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.reshape(-1, self.dims.d_model)


def attn_init(generator: torch.Generator, dims: AttnDims,
              dtype=DEFAULT_DTYPE) -> Attention:
    """An :class:`Attention` on the generator's device, weights drawn with
    :func:`dense_init`, biases zero."""
    p = Attention(dims, dtype, generator.device)
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            w = getattr(p, name)
            w.copy_(dense_init(generator, tuple(w.shape), dtype))
        if dims.qkv_bias:
            for name in ("bq", "bk", "bv"):
                getattr(p, name).zero_()
    return p


def _once(memo: dict | None, key, make):
    """``make()``, kept in ``memo`` under ``key`` when a memo is given."""
    if memo is None:
        return make()
    if key not in memo:
        memo[key] = make()
    return memo[key]


def attn_apply(p: Attention, x: torch.Tensor, *, positions: torch.Tensor,
               kv_cache=None, cache_index: int | None = None,
               causal: bool = True, chunk: int = 0, impl: str = "xla",
               memo: dict | None = None) -> torch.Tensor:
    """Returns out [B, S, d].  ``kv_cache`` ([B, T, n_kv, D] k and v) is
    written in place at ``cache_index``.  With ``impl="pallas"``, a pass
    without a cache or a prefill at offset 0 attends over the fresh tokens
    on the flash-attention kernel, causal and within ``chunk`` as the
    einsum path masks them (the JAX package's "pallas" path drops the
    chunk: ROADMAP §3); ``impl="flash"`` takes ``flash_attention_xla`` there
    (the same masks, differentiable); every other pass
    runs the einsum path, over the whole cache with its slots past the
    fresh tokens masked when there is one (decode, as in the JAX package).
    ``memo`` (a dict, one per pass over the layers) keeps the RoPE tables
    and masks, the same for every layer, so a pass makes them once."""
    S = x.shape[1]
    rope = _once(memo, "rope", lambda: rope_cos_sin(
        positions, p.dims.d_head, p.dims.rope_theta))
    q, k, v = p.project(x, positions, rope)
    if kv_cache is not None:
        ck, cv = kv_cache
        ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
    if impl in ("pallas", "flash") and \
            (kv_cache is None or (cache_index == 0 and S > 1)):
        attend = flash_attention_xla if impl == "flash" else flash_attention
        return p.out(attend(q, k, v, causal=causal, chunk=chunk))
    if kv_cache is None:
        bias = _once(memo, ("bias", causal, chunk), lambda: attention_bias(
            positions, positions, causal=causal, chunk=chunk))
    else:
        k, v = ck, cv

        def cache_bias():                # [1, 1, 1, S, T]
            k_pos = torch.arange(ck.shape[1], device=x.device)
            return attention_bias(positions, k_pos, causal=causal,
                                  chunk=chunk,
                                  kv_valid_len=cache_index + S)[:, None, None]

        bias = _once(memo, ("cache bias", causal, chunk), cache_bias)
    return p.out(gqa_attention(q, k, v, bias, impl="xla"))


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """w_gate, w_up [d_model, d_ff]; w_down [d_ff, d_model]; on ``device``
    (``None`` = the card)."""

    def __init__(self, d_model: int, d_ff: int, dtype=DEFAULT_DTYPE,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.w_gate = _param(d_model, d_ff, **kw)
        self.w_up = _param(d_model, d_ff, **kw)
        self.w_down = _param(d_ff, d_model, **kw)


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             dtype=DEFAULT_DTYPE) -> MLP:
    p = MLP(d_model, d_ff, dtype, generator.device)
    with torch.no_grad():
        for name in ("w_gate", "w_up", "w_down"):
            w = getattr(p, name)
            w.copy_(dense_init(generator, tuple(w.shape), dtype))
    return p


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    hidden = torch.nn.functional.silu(x @ p.w_gate) * (x @ p.w_up)
    return hidden @ p.w_down
