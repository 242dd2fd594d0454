"""Wrapper of the top-k kernel (``csrc/topk.cu``).

For a CUDA tensor it launches the kernel, which serves ``k <=
MAX_KERNEL_K`` and raises for a larger k (the IR fusion pass lowers onto
the kernel only within that bound); for a CPU tensor it takes the plain
version.  There is no fallback from a failed launch: it raises.
``streaming_topk.launches`` counts kernel launches, and only those.
In a pricing run (``kernels/pricing.py``) a call is priced by :func:`cost`
and launches nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pricing import priced, topk_outputs
from repro_torch.kernels.segments import plan_segments
from repro_torch.kernels.topk.ref import streaming_topk_ref

MAX_KERNEL_K = 128
#: shortest row segment worth a block of its own
MIN_SEGMENT = 4096


def plan(nq: int, n: int, k: int, n_sm: int) -> tuple[int, int]:
    """(segments per row, segment length) of the kernel's first stage: one
    wave of two blocks an SM."""
    return plan_segments(nq, n, k, n_sm, min_len=MIN_SEGMENT, one_wave=True)


def kernel_native(k: int) -> bool:
    """Whether the kernel serves this ``k``.  The IR fusion pass
    (core/passes.py) records this."""
    return k <= MAX_KERNEL_K


def cost(scores: torch.Tensor, *, k: int) -> tuple[float, float]:
    """(flops, bytes) of one call: the score rows read once, the k values
    and int32 indices of each row written once, one comparison a score."""
    n = scores.shape[-1]
    nq = scores.numel() // max(n, 1)
    return float(nq * n), float(nq * n * scores.element_size() + nq * k * 8)


def _outputs(scores: torch.Tensor, *, k: int):
    return topk_outputs(tuple(scores.shape[:-1]), k, scores.shape[-1],
                        scores.device)


@priced(cost, _outputs)
def streaming_topk(scores: torch.Tensor, *, k: int):
    """Top-``k`` of each row of ``scores`` [NQ, N] (or one row [N]): values
    sorted descending (f32) and their int32 indices, -0.0 below +0.0, ties
    to the lowest index (the ``lax.top_k`` rule)."""
    if scores.dim() not in (1, 2):
        raise ValueError(f"scores must be [N] or [NQ, N], got {tuple(scores.shape)}")
    n = scores.shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"k={k} outside [1, {n}]")
    if not scores.is_cuda:
        return streaming_topk_ref(scores, k=k)
    if not kernel_native(k):
        raise ValueError(f"k={k} > {MAX_KERNEL_K}: the top-k kernel serves "
                         f"k <= {MAX_KERNEL_K}")
    # rows may lie apart, as a slice of wider score rows does: the kernel
    # takes their stride, so only rows that are not laid out so are copied
    rows = scores.reshape(-1, n).to(torch.float32)
    nq = rows.shape[0]
    if rows.stride(-1) != 1 or (nq > 1 and rows.stride(0) < n):
        rows = rows.contiguous()
    row_stride = rows.stride(0) if nq > 1 else n
    dev = rows.device
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        n_seg, seg_len = plan(nq, n, k, n_sm)
        cand_vals = torch.empty((nq, n_seg, k), dtype=torch.float32,
                                device=dev)
        cand_idxs = torch.empty((nq, n_seg, k), dtype=torch.int32, device=dev)
        err = _build.library().repro_topk_f32(
            rows.data_ptr(), nq, n, row_stride, k, n_seg, seg_len,
            cand_vals.data_ptr(), cand_idxs.data_ptr(), vals.data_ptr(),
            idxs.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "repro_topk_f32")
        streaming_topk.launches += 1
    return vals.reshape(*scores.shape[:-1], k), idxs.reshape(*scores.shape[:-1], k)


streaming_topk.launches = 0
