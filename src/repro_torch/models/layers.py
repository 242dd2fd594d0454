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
import math

import torch
from torch import nn

from repro_torch import collectives as C
from repro_torch import sharding as sh
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


def project(dims: AttnDims, w: dict, x: torch.Tensor,
            positions: torch.Tensor, cos_sin=None):
    """The attention projections of x [B, S, d] by the weights ``w``
    (wq, wk, wv and, with ``qkv_bias``, bq, bk, bv; each with its own head
    count) -> q, k, v [B, S, heads, D], RoPE applied to q and k."""
    B, S, d = x.shape

    def proj(w):
        return (x @ w.reshape(d, -1)).reshape(B, S, w.shape[1], dims.d_head)

    q, k, v = proj(w["wq"]), proj(w["wk"]), proj(w["wv"])
    if dims.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    if cos_sin is None:
        cos_sin = rope_cos_sin(positions, dims.d_head, dims.rope_theta)
    return (apply_rope(q, positions, cos_sin=cos_sin),
            apply_rope(k, positions, cos_sin=cos_sin), v)


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
        w = {n: getattr(self, n) for n in ("wq", "wk", "wv") +
             (("bq", "bk", "bv") if self.dims.qkv_bias else ())}
        return project(self.dims, w, x, positions, cos_sin)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """[B, S, n_q, D] -> [B, S, d_model]."""
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.reshape(-1, self.dims.d_model)


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


# ---------------------------------------------------------------------------
# the sublayers on a mesh: each module's parameters are the rank's shards,
# their specs in ``module.shard_specs`` (``transformer_lm.TransformerLM``)
# ---------------------------------------------------------------------------

def gather_at_use(w: torch.Tensor, spec, mesh, keep=()) -> torch.Tensor:
    """The rank's shard ``w`` of a weight with every sharded dim gathered
    but those in ``keep``: the ZeRO-3 gather at use, one layer at a
    time."""
    for i in range(w.dim()):
        if i not in keep:
            w = C.all_gather(w, mesh, sh.spec_axes(spec, i), i)
    return w


def tp_axes(mesh, dims, token_axes) -> tuple[str, ...]:
    """The axes over which a sublayer runs tensor-parallel: those that
    shard every (spec, dim) of ``dims`` alike, where none of them also
    shards the tokens (ranks along them hold the same rows); else ()."""
    axes = {sh.spec_axes(spec, d) for spec, d in dims}
    if len(axes) != 1:
        return ()
    (axes,) = axes
    return () if set(axes) & set(token_axes) else axes


def _offset(mesh, axes, n_local: int) -> int:
    """Where this rank's block of ``n_local`` starts along a dim sharded
    over ``axes``."""
    return sh.shard_index(mesh, axes, mesh.coords) * n_local


def _kv_for_heads(k, v, h0: int, n_local: int, n_q: int):
    """k, v with all kv heads -> those that q heads [h0, h0 + n_local)
    read, laid out so that local q head i reads local kv head i // G'."""
    G = n_q // k.shape[2]
    if n_local % G == 0 or G % n_local == 0:
        lo = h0 // G
        n = max(1, n_local // G)
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = torch.div(torch.arange(h0, h0 + n_local, device=k.device), G,
                    rounding_mode="floor")
    return k[:, :, idx], v[:, :, idx]


def _heads_to_seq(t, mesh, head_axes, seq_axes, T_local: int):
    """t [B, S, h, D] (this rank's kv heads of every fresh position) ->
    [B, T_local, h * m, D]: all heads of the positions of this rank's cache
    slice, by one all-to-all over ``head_axes`` (m ranks), positions past
    S zero."""
    m = math.prod(mesh.shape[a] for a in head_axes)
    S = t.shape[1]
    T = T_local * math.prod(mesh.shape[a] for a in seq_axes)
    if S < T:
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, T - S))
    starts = []
    for j in range(m):
        coords = dict(mesh.coords)
        rest = j
        for a in reversed(head_axes):
            coords[a] = rest % mesh.shape[a]
            rest //= mesh.shape[a]
        starts.append(sh.shard_index(mesh, seq_axes, coords) * T_local)
    send = torch.stack([t[:, s:s + T_local] for s in starts])
    recv = C.all_to_all(send, mesh, head_axes)      # [m, B, T_l, h, D]
    B, h, D = t.shape[0], t.shape[2], t.shape[3]
    return recv.permute(1, 2, 0, 3, 4).reshape(B, T_local, m * h, D)


def _decode_attention(q, ck, cv, bias, mesh, seq_axes):
    """One decode position's GQA attention over a cache whose positions
    are sharded over ``seq_axes``: q [B, 1, n_q, D] (all heads), this
    rank's ck/cv [B, T_l, n_kv, D], bias [.., 1, T_l].  The softmax runs
    across the shards: the scores' max and the sum of their exponentials
    are all-reduced, so each rank's probabilities are the unsharded ones;
    the products with v are summed over the shards in fp32."""
    B, S, n_q, D = q.shape
    n_kv = ck.shape[2]
    qg = q.reshape(B, S, n_kv, n_q // n_kv, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          ck.to(torch.float32))
    while bias.dim() < scores.dim():
        bias = bias[None]
    scores.mul_(D ** -0.5).add_(bias)
    top = C.all_reduce(scores.amax(-1, keepdim=True), mesh, seq_axes, "max")
    p = torch.exp(scores.sub_(top))
    total = C.all_reduce(p.sum(-1, keepdim=True), mesh, seq_axes)
    probs = p.div_(total).to(cv.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, cv).to(torch.float32)
    out = C.all_reduce(out, mesh, seq_axes)
    return out.to(q.dtype).reshape(B, S, n_q, D)


def attn_apply_sharded(p: Attention, x: torch.Tensor, *,
                       positions: torch.Tensor, kv_cache, cache_index: int,
                       chunk: int = 0, impl: str = "xla", mesh,
                       token_axes=(), seq_axes=(),
                       memo: dict | None = None) -> torch.Tensor:
    """:func:`attn_apply` on a mesh, for a prefill at offset 0 or a
    decode step of one position.  x [B_l, S, d] is the rank's rows
    (sharded over ``token_axes``); ``kv_cache`` the rank's cache slice
    [B_l, T_l, n_kv, D], its positions sharded over ``seq_axes``.

    q heads run Megatron-style over the axes that shard both wq's and
    wo's Q_HEADS dims (the output projection's partial sums all-reduced
    there); kv heads too when KV_HEADS is sharded alike, else every rank
    computes them all.  A weight's EMBED and HEAD_DIM shards are gathered
    at use.  A prefill writes its rank's cache slice (all heads of its
    positions: one all-to-all from local heads) and attends over the fresh
    tokens on its local heads, on the flash-attention kernel with
    ``impl="pallas"``; a decode step gathers q's heads, writes the new
    position on the rank that holds it, and attends over the sharded cache
    (:func:`_decode_attention`), as the einsum path."""
    dims, specs = p.dims, p.shard_specs
    S = x.shape[1]
    bias_names = ("bq", "bk", "bv") if dims.qkv_bias else ()
    q_dims = [(specs["wq"], 1), (specs["wo"], 0)] + \
        ([(specs["bq"], 0)] if dims.qkv_bias else [])
    kv_dims = [(specs[n], 1) for n in ("wk", "wv")] + \
        [(specs[n], 0) for n in bias_names[1:]]
    aq = tp_axes(mesh, q_dims, token_axes)
    akv = tp_axes(mesh, kv_dims, token_axes)
    if akv != aq:
        akv = ()
    w = {}
    for name in ("wq", "wk", "wv") + bias_names:
        axes = aq if name[1] == "q" else akv
        head_dim = 1 if name[0] == "w" else 0
        w[name] = gather_at_use(getattr(p, name), specs[name], mesh,
                                (head_dim,) if axes else ())
    wo = gather_at_use(p.wo, specs["wo"], mesh, (0,) if aq else ())
    rope = _once(memo, "rope", lambda: rope_cos_sin(
        positions, dims.d_head, dims.rope_theta))
    q, k, v = project(dims, w, x, positions, rope)
    n_q_l = q.shape[2]
    h0 = _offset(mesh, aq, n_q_l)
    ck, cv = kv_cache
    T_l = ck.shape[1]
    t0 = _offset(mesh, seq_axes, T_l)
    if cache_index == 0 and S > 1:
        if akv:
            kf = _heads_to_seq(k, mesh, akv, seq_axes, T_l)
            vf = _heads_to_seq(v, mesh, akv, seq_axes, T_l)
            n = max(0, min(T_l, S - t0))
            ck[:, :n] = kf[:, :n].to(ck.dtype)
            cv[:, :n] = vf[:, :n].to(cv.dtype)
            kl, vl = k, v
        else:
            n = max(0, min(T_l, S - t0))
            ck[:, :n] = k[:, t0:t0 + n].to(ck.dtype)
            cv[:, :n] = v[:, t0:t0 + n].to(cv.dtype)
            kl, vl = (k, v) if not aq else \
                _kv_for_heads(k, v, h0, n_q_l, dims.n_q)
        if impl in ("pallas", "flash"):
            attend = flash_attention_xla if impl == "flash" \
                else flash_attention
            out = attend(q, kl, vl, causal=True, chunk=chunk)
        else:
            bias = _once(memo, ("bias", chunk), lambda: attention_bias(
                positions, positions, causal=True, chunk=chunk))
            out = gqa_attention(q, kl, vl, bias, impl="xla")
    elif S == 1:
        k = C.all_gather(k, mesh, akv, 2)
        v = C.all_gather(v, mesh, akv, 2)
        if t0 <= cache_index < t0 + T_l:
            ck[:, cache_index - t0] = k[:, 0].to(ck.dtype)
            cv[:, cache_index - t0] = v[:, 0].to(cv.dtype)

        def cache_bias():                # [1, 1, 1, 1, T_l]
            k_pos = t0 + torch.arange(T_l, device=x.device)
            return attention_bias(positions, k_pos, causal=True, chunk=chunk,
                                  kv_valid_len=cache_index + 1
                                  )[:, None, None]

        bias = _once(memo, ("cache bias", chunk), cache_bias)
        out = _decode_attention(C.all_gather(q, mesh, aq, 2), ck, cv, bias,
                                mesh, seq_axes)[:, :, h0:h0 + n_q_l]
    else:
        raise NotImplementedError(
            f"a pass of {S} positions at offset {cache_index}: on a mesh "
            f"the LM runs a prefill at offset 0 or one decode position")
    B = x.shape[0]
    y = out.reshape(B, S, -1) @ wo.reshape(-1, dims.d_model)
    return C.all_reduce(y, mesh, aq)


def mlp_apply_sharded(p: MLP, x: torch.Tensor, mesh,
                      token_axes=()) -> torch.Tensor:
    """:func:`mlp_apply` on a mesh: column-parallel gate and up,
    row-parallel down (its partial sums all-reduced) over the axes that
    shard the three MLP dims alike; the EMBED shards gathered at use."""
    specs = p.shard_specs
    am = tp_axes(mesh, [(specs["w_gate"], 1), (specs["w_up"], 1),
                        (specs["w_down"], 0)], token_axes)
    wg = gather_at_use(p.w_gate, specs["w_gate"], mesh, (1,) if am else ())
    wu = gather_at_use(p.w_up, specs["w_up"], mesh, (1,) if am else ())
    wd = gather_at_use(p.w_down, specs["w_down"], mesh, (0,) if am else ())
    hidden = torch.nn.functional.silu(x @ wg) * (x @ wu)
    return C.all_reduce(hidden @ wd, mesh, am)


def embed_lookup(embed: torch.Tensor, spec, tokens: torch.Tensor, mesh,
                 token_axes=(), dtype=DEFAULT_DTYPE) -> torch.Tensor:
    """``embed[tokens]`` in ``dtype`` from the rank's shard of the
    embedding [vocab, d]: vocab-parallel where VOCAB is sharded (each rank
    looks up the ids in its rows, zeros elsewhere, and the rows are
    all-reduced), the EMBED shard gathered at use."""
    av = tp_axes(mesh, [(spec, 0)], token_axes)
    w = gather_at_use(embed, spec, mesh, (0,) if av else ()).to(dtype)
    ids = tokens.long()
    if not av:
        return w[ids]
    n = w.shape[0]
    ids = ids - _offset(mesh, av, n)
    mine = (ids >= 0) & (ids < n)
    x = torch.where(mine[..., None], w[ids.clamp(0, n - 1)], 0)
    return C.all_reduce(x, mesh, av)


def vocab_logits(x: torch.Tensor, w: torch.Tensor, spec, vocab_dim: int,
                 mesh, token_axes=(), dtype=DEFAULT_DTYPE):
    """(x [B_l, d] @ the unembedding in ``dtype``, the axes its vocab
    columns are sharded over): ``w`` the rank's shard of the unembedding
    [d, vocab] (``vocab_dim`` 1) or of the tied embedding [vocab, d]
    (``vocab_dim`` 0).  The logits stay vocab-sharded where VOCAB is."""
    av = tp_axes(mesh, [(spec, vocab_dim)], token_axes)
    w = gather_at_use(w, spec, mesh, (vocab_dim,) if av else ()).to(dtype)
    return x @ (w.T if vocab_dim == 0 else w), av
