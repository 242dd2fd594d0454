"""Wrapper of the PQ/ADC-scoring kernel (``csrc/pq_topk.cu``).

For a CUDA tensor it launches the kernel, which serves ``k <=
MAX_KERNEL_K`` and raises for a larger k (the IR fusion pass lowers onto
the kernel only within that bound); for a CPU tensor it takes the plain
version.  There is no fallback from a failed launch: it raises.
``streaming_pq_topk.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dense_scoring.ops import MIN_SEGMENT, SCORE_SLOTS
from repro_torch.kernels.pq_scoring.ref import pq_topk_ref
from repro_torch.kernels.segments import plan_segments

MAX_KERNEL_K = 128


def kernel_native(k: int) -> bool:
    """Whether the kernel serves this shortlist depth.  The IR fusion pass
    (core/passes.py) records this."""
    return k <= MAX_KERNEL_K


def streaming_pq_topk(codes: torch.Tensor, table: torch.Tensor,
                      base: torch.Tensor | None = None, *, k: int):
    """Top-``k`` of the ADC scores ``table[0, c_0] + ... + table[m-1,
    c_{m-1}] + base`` of each query's rows: values sorted descending (f32)
    and their int32 row indices, ties to the lowest index (the
    ``lax.top_k`` rule; documents that share a code word tie).

    ``codes`` [NQ, N, m] uint8 (each code < n_codes), ``table``
    [NQ, m, n_codes], ``base`` [NQ, N] or None (0)."""
    if codes.dim() != 3 or table.dim() != 3 or codes.dtype != torch.uint8 \
            or table.shape[:2] != (codes.shape[0], codes.shape[2]):
        raise ValueError(f"codes must be [NQ, N, m] uint8 and table "
                         f"[NQ, m, n_codes]: got {tuple(codes.shape)} "
                         f"{codes.dtype}, {tuple(table.shape)}")
    nq, n, m = codes.shape
    n_codes = table.shape[2]
    if base is not None and tuple(base.shape) != (nq, n):
        raise ValueError(f"base must be [{nq}, {n}], got {tuple(base.shape)}")
    if not 0 < k <= n:
        raise ValueError(f"k={k} outside [1, {n}]")
    if not codes.is_cuda:
        return pq_topk_ref(codes, table, base, k=k)
    if not kernel_native(k):
        raise ValueError(f"k={k} > {MAX_KERNEL_K}: the PQ-scoring kernel "
                         f"serves k <= {MAX_KERNEL_K}")
    tensors = [codes, table] + ([] if base is None else [base])
    if any(t.device != codes.device for t in tensors):
        raise ValueError("codes, table and base must lie on one device")
    dev = codes.device
    codes = codes.contiguous()
    table = table.to(torch.float32).contiguous()
    if base is not None:
        base = base.to(torch.float32).contiguous()
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, idxs
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_seg, seg_len = plan_segments(nq, n, k, n_sm, min_len=MIN_SEGMENT,
                                   cap=SCORE_SLOTS)
    cand_vals = torch.empty((nq, n_seg, k), dtype=torch.float32, device=dev)
    cand_idxs = torch.empty((nq, n_seg, k), dtype=torch.int32, device=dev)
    err = _build.library().repro_pq_topk(
        codes.data_ptr(), table.data_ptr(),
        None if base is None else base.data_ptr(), nq, n, m, n_codes, k,
        n_seg, seg_len, cand_vals.data_ptr(), cand_idxs.data_ptr(),
        vals.data_ptr(), idxs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "repro_pq_topk")
    streaming_pq_topk.launches += 1
    return vals, idxs


streaming_pq_topk.launches = 0
