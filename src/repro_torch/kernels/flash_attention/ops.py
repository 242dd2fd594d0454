"""Wrapper of the flash-attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_sm90.cu``).

For a CUDA tensor it launches a kernel of d_head 64 or 128: fp32 inputs go
to the fp32 kernel on the CUDA cores, bf16 inputs to the bf16 kernel on the
tensor cores (wgmma fed by TMA, which asks each of q, k, v to start on a
16-byte boundary); anything else raises.  For a CPU tensor it takes the
plain version.  There is no fallback from a failed launch: it raises.
``flash_attention.launches`` counts kernel launches of both, and only
those.
The JAX package's layout, q [B, S, H, D] and k/v [B, T, Hkv, D], stays at
this function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

KERNEL_D_HEADS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: bytes to which the bf16 kernel's TMA tensor maps need q, k, v aligned
TMA_ALIGN = 16


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, chunk: int = 0) -> torch.Tensor:
    """Causal (``causal``) grouped-query attention, optionally restricted
    to same-``chunk`` blocks of positions, softmax in fp32, both position
    axes counted from 0.  q [B, S, H, D]; k/v [B, T, Hkv, D] ->
    [B, S, H, D] in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or \
            q.shape[2] % k.shape[2]:
        raise ValueError(f"q must be [B, S, H, D] and k, v [B, T, Hkv, D] "
                         f"with H % Hkv == 0: got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if chunk < 0:
        raise ValueError(f"chunk={chunk} < 0")
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, chunk=chunk)
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % TMA_ALIGN
                                         for t in (q, k, v)):
        raise ValueError(f"the bf16 flash-attention kernel reads q, k, v "
                         f"through TMA, which needs each to start on a "
                         f"{TMA_ALIGN}-byte boundary: got data_ptr offsets "
                         f"{[t.data_ptr() % TMA_ALIGN for t in (q, k, v)]}")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    if T == 0:
        raise ValueError("no keys: T == 0")
    err = _build.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T,
        H, HKV, D, int(causal), int(chunk), int(q.dtype == torch.bfloat16),
        D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "repro_flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
