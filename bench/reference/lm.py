"""Plain decoder LM forward, as Qwen2 is published: token embedding,
pre-norm blocks (RMSNorm, grouped-query attention with QKV biases and
rotate-half RoPE, causal softmax; RMSNorm, SwiGLU MLP), a final RMSNorm
and the tied embedding as the output head.  Float32 throughout, TF32 off
(the caller sets it), with no cache and no batching tricks: each block of
sequences runs whole, layer by layer.

Weights are the benchmark's own draws, a dict of tensors in the layout
the configuration file names (``embed`` [vocab, d]; per layer ``wq``
[d, n_q, d_head], ``wk``/``wv`` [d, n_kv, d_head], ``wo`` [n_q, d_head,
d], ``bq``/``bk``/``bv``, ``ln_attn``/``ln_mlp`` [d], ``w_gate``/``w_up``
[d, d_ff], ``w_down`` [d_ff, d]; ``ln_final`` [d]).

``lowp`` computes every matrix product from operands rounded to float8
e4m3 with one scale a tensor: the control's precision for a bfloat16
model."""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale, back in float32."""
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(a, b, lowp: bool):
    if lowp:
        a, b = fp8(a), fp8(b)
    return a @ b


def rmsnorm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def rope(x, theta: float):
    """x [B, S, H, D] at positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward_logits(lm: dict, w: dict, tokens: torch.Tensor, first: int,
                   lowp: bool = False) -> torch.Tensor:
    """Logits [B, S - first, vocab] (float32) at positions first..S-1 of
    tokens [B, S]."""
    d, nq, nkv, dh = lm["d_model"], lm["n_q"], lm["n_kv"], lm["d_head"]
    eps = lm["norm_eps"]
    B, S = tokens.shape
    f32 = torch.float32
    x = w["embed"][tokens.long()].to(f32)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    for i in range(lm["n_layers"]):
        p = {k: v.to(f32) for k, v in w["layers"][i].items()}
        h = rmsnorm(x, p["ln_attn"], eps)
        q = _mm(h, p["wq"].reshape(d, -1), lowp).reshape(B, S, nq, dh)
        k = _mm(h, p["wk"].reshape(d, -1), lowp).reshape(B, S, nkv, dh)
        v = _mm(h, p["wv"].reshape(d, -1), lowp).reshape(B, S, nkv, dh)
        if lm["qkv_bias"]:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q, k = rope(q, lm["rope_theta"]), rope(k, lm["rope_theta"])
        k = k.repeat_interleave(nq // nkv, dim=2)
        v = v.repeat_interleave(nq // nkv, dim=2)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, D]
        sc = _mm(qh, kh.transpose(-1, -2), lowp) * dh ** -0.5
        sc = sc.masked_fill(~mask, float("-inf"))
        o = _mm(torch.softmax(sc, dim=-1), vh, lowp)
        o = o.transpose(1, 2).reshape(B, S, nq * dh)
        x = x + _mm(o, p["wo"].reshape(nq * dh, d), lowp)
        h = rmsnorm(x, p["ln_mlp"], eps)
        a = torch.nn.functional.silu(_mm(h, p["w_gate"], lowp)) * \
            _mm(h, p["w_up"], lowp)
        x = x + _mm(a, p["w_down"], lowp)
        del p, q, k, v, qh, kh, vh, sc, o, h, a
    x = rmsnorm(x[:, first:], w["ln_final"].to(f32), eps)
    return _mm(x, w["embed"].to(f32).T, lowp)
