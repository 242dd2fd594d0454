"""Wrapper of the flash-attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_sm90.cu``).

For a CUDA tensor it launches a kernel of d_head 32, 64 or 128: fp32
inputs go to the fp32 kernel on the CUDA cores, bf16 inputs to the bf16
kernel on the tensor cores (wgmma fed by TMA, which asks each of q, k, v to
start on a 16-byte boundary; its tiles are 64 columns wide, so a bf16 head
of 32 is zero-padded to 64 here, with the scale of 32, and the output cut
back); anything else raises.  For a CPU tensor it takes the
plain version.  There is no fallback from a failed launch: it raises.
``flash_attention.launches`` counts kernel launches of both, and only
those.  Its output has no ``grad_fn``: on a CUDA tensor under grad mode it
raises for a q, k or v that requires grad (the JAX package's Pallas kernel
has no VJP either), and training takes :func:`flash_attention_xla`.
The JAX package's layout, q [B, S, H, D] and k/v [B, T, Hkv, D], stays at
this function.

:func:`flash_attention_xla` is the training path (the port of the JAX
package's ``flash_attention_xla``, ``attn_impl="flash"``): an
``autograd.Function`` whose forward is the kernel on a CUDA tensor and the
plain q-chunked forward on the CPU, and whose backward recomputes the
scores a block of q rows at a time in fp32 (the port of
``_flash_chunked_bwd``; the JAX package has no backward kernel), so it
keeps only q, k, v and o between the passes.
"""
from __future__ import annotations

import torch

from repro_torch.common import on_card
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import NEG, attention_mask, \
    flash_attention_ref
from repro_torch.kernels.pricing import priced

KERNEL_D_HEADS = (32, 64, 128)
#: the bf16 kernel's narrowest head; a narrower one is zero-padded to it
SM90_MIN_D_HEAD = 64
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: bytes to which the bf16 kernel's TMA tensor maps need q, k, v aligned
TMA_ALIGN = 16


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or \
            q.shape[2] % k.shape[2]:
        raise ValueError(f"q must be [B, S, H, D] and k, v [B, T, Hkv, D] "
                         f"with H % Hkv == 0: got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def check_no_grad(q, k, v) -> None:
    """Raise where the kernel's output would silently drop gradients: grad
    mode on and any of q, k, v requiring grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention launches the kernel with no backward: its "
            "output would carry no gradient to q, k, v.  Train with "
            "attn_impl=\"flash\" (flash_attention_xla), or call it under "
            "torch.no_grad()")


def visible_pairs(S: int, T: int, causal: bool = True, chunk: int = 0) -> int:
    """(query, key) pairs attention of S queries over T keys visits, both
    counted from position 0: causal (key <= query) where ``causal``, and
    within blocks of ``chunk`` positions (0: one block)."""
    c = chunk or max(S, T)
    total = 0
    for start in range(0, S, c):
        rows = min(S, start + c) - start
        keys = min(T, start + c) - start
        if keys <= 0:
            continue
        if causal:
            full = min(rows, keys)
            total += full * (full + 1) // 2 + max(0, rows - keys) * keys
        else:
            total += rows * keys
    return total


def cost(q, k, v, *, causal: bool = True, chunk: int = 0):
    """(flops, bytes) of one kernel call: two products of 2 x D operations
    a visible (query, key) pair and head, q, k, v read once and the output
    written once."""
    B, S, H, D = q.shape
    pairs = visible_pairs(S, k.shape[1], causal, chunk)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    return 4.0 * B * H * D * pairs, float(nbytes)


def _outputs(q, k, v, *, causal: bool = True, chunk: int = 0):
    return torch.zeros_like(q)


@priced(cost, _outputs)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, chunk: int = 0) -> torch.Tensor:
    """Causal (``causal``) grouped-query attention, optionally restricted
    to same-``chunk`` blocks of positions, softmax in fp32, both position
    axes counted from 0.  q [B, S, H, D]; k/v [B, T, Hkv, D] ->
    [B, S, H, D] in q's dtype."""
    _check_shapes(q, k, v)
    if chunk < 0:
        raise ValueError(f"chunk={chunk} < 0")
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, chunk=chunk)
    check_no_grad(q, k, v)
    B, S, H, D = q.shape
    T, HKV = k.shape[1], k.shape[2]
    if D not in KERNEL_D_HEADS:
        raise ValueError(f"d_head={D}: the flash-attention kernel takes "
                         f"d_head in {KERNEL_D_HEADS}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         f"flash-attention kernel takes q, k, v all float32 "
                         f"or all bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    scale = D ** -0.5
    D_run = D
    if q.dtype == torch.bfloat16 and D < SM90_MIN_D_HEAD:
        # zero columns add nothing to q k^T, and give zero output columns
        pad = (0, SM90_MIN_D_HEAD - D)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
        D_run = SM90_MIN_D_HEAD
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % TMA_ALIGN
                                         for t in (q, k, v)):
        raise ValueError(f"the bf16 flash-attention kernel reads q, k, v "
                         f"through TMA, which needs each to start on a "
                         f"{TMA_ALIGN}-byte boundary: got data_ptr offsets "
                         f"{[t.data_ptr() % TMA_ALIGN for t in (q, k, v)]}")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out[..., :D]
    if T == 0:
        raise ValueError("no keys: T == 0")
    with on_card(q.device):
        err = _build.library().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            T, H, HKV, D_run, int(causal), int(chunk),
            int(q.dtype == torch.bfloat16), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "repro_flash_attention")
    flash_attention.launches += 1
    return out[..., :D].contiguous() if D_run != D else out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# the training path: q-chunked flash with a recomputing backward
# ---------------------------------------------------------------------------

#: q rows a block of the plain forward and of the backward (the JAX
#: package's ``FLASH_BQ``)
FLASH_BQ = 512


def _block_scores(qb, k, ok):
    """fp32 scores [B, bq, Hkv, G, T] of the q rows qb [B, bq, Hkv, G, D]
    against k [B, T, Hkv, D], -1e30 where ``ok`` [bq, T] is False."""
    s = torch.einsum("bqkgd,btkd->bqkgt", qb.float(), k.float())
    return torch.where(ok[None, :, None, None, :], s * qb.shape[-1] ** -0.5,
                       NEG)


def _flash_chunked_fwd(q, k, v, causal: bool, chunk: int, bq: int):
    """The plain forward, a block of ``bq`` q rows at a time, each row
    seeing its whole kv row (the port of ``_fwd_block`` and
    ``_flash_chunked_fwd_impl``): fp32 scores, probabilities cast to v's
    dtype before the PV product, then divided by their fp32 sum."""
    B, S, H, D = q.shape
    HKV = k.shape[2]
    qg = q.reshape(B, S, HKV, H // HKV, D)
    ok = attention_mask(S, k.shape[1], causal=causal, chunk=chunk,
                        device=q.device)
    out = torch.empty_like(q)
    for q0 in range(0, S, bq):
        s = _block_scores(qg[:, q0:q0 + bq], k, ok[q0:q0 + bq])
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True).clamp_min(1e-20)
        o = torch.einsum("bqkgt,btkd->bqkgd", p.to(v.dtype), v)
        out[:, q0:q0 + bq] = (o / l.to(o.dtype)).reshape(B, -1, H, D)
    return out


def _flash_chunked_bwd(q, k, v, o, do, causal: bool, chunk: int, bq: int):
    """(dq, dk, dv) in fp32 math, a block of ``bq`` q rows at a time (the
    port of ``_flash_chunked_bwd``).  Each block's probabilities are the
    softmax of its recomputed scores, each row's whole kv row at once:
    ``exp(s - lse)`` of the reference up to rounding, without saving lse.
    dk and dv sum over the G q heads that share a kv head."""
    B, S, H, D = q.shape
    T, HKV = k.shape[1], k.shape[2]
    G = H // HKV
    scale = D ** -0.5
    qg = q.reshape(B, S, HKV, G, D).float()
    dog = do.reshape(B, S, HKV, G, D).float()
    delta = (dog * o.reshape(B, S, HKV, G, D).float()).sum(-1)
    k32, v32 = k.float(), v.float()
    ok = attention_mask(S, T, causal=causal, chunk=chunk, device=q.device)
    dq = torch.empty((B, S, HKV, G, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, T, HKV, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, S, bq):
        blk = slice(q0, q0 + bq)
        p = torch.softmax(_block_scores(qg[:, blk], k32, ok[blk]), -1)
        dp = torch.einsum("bqkgd,btkd->bqkgt", dog[:, blk], v32)
        ds = p * (dp - delta[:, blk, ..., None]) * scale
        dq[:, blk] = torch.einsum("bqkgt,btkd->bqkgd", ds, k32)
        dk += torch.einsum("bqkgt,bqkgd->btkd", ds, qg[:, blk])
        dv += torch.einsum("bqkgt,bqkgd->btkd", p, dog[:, blk])
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashXLA(torch.autograd.Function):
    """Flash attention with a recomputing backward; q, k, v, o saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int, bq: int):
        if q.is_cuda:
            o = flash_attention(q, k, v, causal=causal, chunk=chunk)
        else:
            o = _flash_chunked_fwd(q, k, v, causal, chunk, bq)
        ctx.save_for_backward(q, k, v, o)
        ctx.args = (causal, chunk, bq)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        return (*_flash_chunked_bwd(q, k, v, o, do, *ctx.args),
                None, None, None)


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, chunk: int = 0,
                        bq: int = FLASH_BQ) -> torch.Tensor:
    """Differentiable causal GQA flash attention, q [B, S, H, D] and k/v
    [B, T, Hkv, D] unexpanded -> [B, S, H, D] in q's dtype.  On a CUDA
    tensor the forward is the kernel (fp32 or bf16, d_head 32, 64 or 128;
    it raises for anything else, with no fallback) and counts
    ``flash_attention.launches``; on the CPU it is the plain q-chunked
    forward.  ``bq`` halves until it divides S, as in the JAX package."""
    _check_shapes(q, k, v)
    S = q.shape[1]
    bq_eff = min(bq, S)
    while bq_eff > 1 and S % bq_eff:
        bq_eff //= 2
    return FlashXLA.apply(q, k, v, causal, chunk, max(bq_eff, 1))
