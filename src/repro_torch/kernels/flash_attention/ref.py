"""Plain torch version of the flash-attention kernel: the expression of
``src/repro/kernels/flash_attention/ref.py`` (fp32 math, masked scores
-1e30, softmax, output cast to q's dtype)."""
from __future__ import annotations

import torch

NEG = -1e30


def attention_mask(S: int, T: int, *, causal: bool, chunk: int,
                   device) -> torch.Tensor:
    """[S, T] bool: which (query, key) positions, both counted from 0, may
    attend."""
    qi = torch.arange(S, device=device)[:, None]
    ki = torch.arange(T, device=device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if chunk:
        ok &= (ki // chunk) == (qi // chunk)
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, chunk: int = 0):
    """q [B, S, H, D]; k/v [B, T, Hkv, D] -> [B, S, H, D] in q's dtype.
    The math runs in fp32, or in float64 for float64 inputs (the exact
    function that ``chip_smoke.py`` holds the kernel against)."""
    B, S, H, D = q.shape
    T, HKV = k.shape[1], k.shape[2]
    G = H // HKV
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, S, HKV, G, D).to(acc)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(acc)) * D ** -0.5
    ok = attention_mask(S, T, causal=causal, chunk=chunk, device=q.device)
    s = torch.where(ok, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(acc))
    return out.reshape(B, S, H, D).to(q.dtype)
