"""Wrapper of the top-k kernel (``csrc/topk.cu``).

For a CUDA tensor it launches the kernel (``k <= MAX_KERNEL_K``) or serves
larger ``k`` with the plain helper, as ``kernels/topk/ops.py`` of the JAX
package does; for a CPU tensor it takes the plain version.  There is no
fallback from a failed launch: it raises.  ``streaming_topk.launches``
counts kernel launches, and only those.
"""
from __future__ import annotations

import torch

from repro_torch.common import cdiv
from repro_torch.kernels import _build
from repro_torch.kernels.topk.ref import streaming_topk_ref

MAX_KERNEL_K = 128
#: shortest row segment worth a block of its own
MIN_SEGMENT = 4096


def kernel_native(k: int) -> bool:
    """Whether the kernel itself serves this ``k`` (larger k goes to the
    plain helper).  The IR fusion pass (core/passes.py) records this."""
    return k <= MAX_KERNEL_K


def segments(nq: int, n: int, k: int, n_sm: int) -> int:
    """How many segments the kernel cuts each row into: enough for about
    two blocks per SM across the batch, each segment at least
    ``MIN_SEGMENT`` long and the last one holding at least ``k``."""
    s = max(1, min(cdiv(2 * n_sm, nq), n // max(k, MIN_SEGMENT)))
    while s > 1 and n - (s - 1) * cdiv(n, s) < k:
        s -= 1
    return s


def streaming_topk(scores: torch.Tensor, *, k: int):
    """Top-``k`` of each row of ``scores`` [NQ, N] (or one row [N]): values
    sorted descending (f32) and their int32 indices, ties to the lowest
    index (the ``lax.top_k`` rule)."""
    if scores.dim() not in (1, 2):
        raise ValueError(f"scores must be [N] or [NQ, N], got {tuple(scores.shape)}")
    n = scores.shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"k={k} outside [1, {n}]")
    if not scores.is_cuda or not kernel_native(k):
        return streaming_topk_ref(scores, k=k)
    rows = scores.reshape(-1, n).to(torch.float32).contiguous()
    nq = rows.shape[0]
    dev = rows.device
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq:
        n_seg = segments(nq, n, k, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        cand_vals = torch.empty((nq, n_seg, k), dtype=torch.float32,
                                device=dev)
        cand_idxs = torch.empty((nq, n_seg, k), dtype=torch.int32, device=dev)
        err = _build.library().repro_topk_f32(
            rows.data_ptr(), nq, n, k, n_seg, cand_vals.data_ptr(),
            cand_idxs.data_ptr(), vals.data_ptr(), idxs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "repro_topk_f32")
        streaming_topk.launches += 1
    return vals.reshape(*scores.shape[:-1], k), idxs.reshape(*scores.shape[:-1], k)


streaming_topk.launches = 0
