"""Wrapper of the dense-scoring kernel (``csrc/dense_topk.cu``).

For a CUDA tensor it launches the kernel, which serves ``k <=
MAX_KERNEL_K`` and raises for a larger k (the IR fusion pass lowers onto
the kernel only within that bound); for a CPU tensor it takes the plain
version.  There is no fallback from a failed launch: it raises.
``streaming_dense_topk.launches`` counts kernel launches, and only those.
In a pricing run (``kernels/pricing.py``) a call is priced by :func:`cost`
and launches nothing.
"""
from __future__ import annotations

import torch

from repro_torch.common import cdiv
from repro_torch.kernels import _build
from repro_torch.kernels.pricing import priced, topk_outputs
from repro_torch.kernels.dense_scoring.ref import dense_topk_ref
from repro_torch.kernels.segments import plan_segments

MAX_KERNEL_K = 128
#: queries one block scores together over shared embeddings, and the
#: scores a block keeps in shared memory (64 KB), shared by its group: a
#: tile of SCORE_SLOTS // group rows
MAX_GROUP = 8
SCORE_SLOTS = 16384
#: shortest row segment worth a block of its own
MIN_SEGMENT = 1024


def plan(nq: int, n: int, k: int, group: int,
         n_sm: int) -> tuple[int, int, int]:
    """(segments per row set, segment length, tile length) of the kernel's
    first stage: one wave of two blocks an SM over segments of any length,
    scored in tiles that fit the shared score buffer (the warp select keeps
    its queues between tiles)."""
    n_seg, seg_len = plan_segments(cdiv(nq, group), n, k, n_sm,
                                   min_len=MIN_SEGMENT, one_wave=True)
    return n_seg, seg_len, min(seg_len, SCORE_SLOTS // group)


def kernel_native(k: int) -> bool:
    """Whether the kernel serves this ``k``.  The IR fusion pass
    (core/passes.py) records this."""
    return k <= MAX_KERNEL_K


def cost(emb: torch.Tensor, qvec: torch.Tensor,
         base: torch.Tensor | None = None, *, k: int) -> tuple[float, float]:
    """(flops, bytes) of one call: emb, the queries and base read once
    (a shared emb once for all queries), the k f32 values and int32
    indices of each query written once, 2·dim flops a scored row."""
    nq, dim = qvec.shape
    n = emb.shape[-2]
    read = sum(x.numel() * 4 for x in (emb, qvec, base) if x is not None)
    return float(2 * nq * n * dim), float(read + nq * k * 8)


def _outputs(emb: torch.Tensor, qvec: torch.Tensor,
             base: torch.Tensor | None = None, *, k: int):
    return topk_outputs((qvec.shape[0],), k, emb.shape[-2], emb.device)


@priced(cost, _outputs)
def streaming_dense_topk(emb: torch.Tensor, qvec: torch.Tensor,
                         base: torch.Tensor | None = None, *, k: int):
    """Top-``k`` of ``emb @ q + base`` for each query: values sorted
    descending (f32) and their int32 row indices, -0.0 below +0.0, ties to
    the lowest index (the ``lax.top_k`` rule).

    ``emb`` is [N, dim], shared by the queries, or [NQ, N, dim], each
    query's own rows; ``qvec`` is [NQ, dim]; ``base`` [NQ, N] or None (0).
    A row whose base is ``NEG`` (-3e38) can never enter the top-k of real
    rows."""
    if qvec.dim() != 2 or emb.dim() not in (2, 3) or \
            emb.shape[-1] != qvec.shape[1] or \
            (emb.dim() == 3 and emb.shape[0] != qvec.shape[0]):
        raise ValueError(f"emb must be [N, dim] or [NQ, N, dim] and qvec "
                         f"[NQ, dim]: got {tuple(emb.shape)}, "
                         f"{tuple(qvec.shape)}")
    nq, dim = qvec.shape
    n = emb.shape[-2]
    if base is not None and tuple(base.shape) != (nq, n):
        raise ValueError(f"base must be [{nq}, {n}], got {tuple(base.shape)}")
    if not 0 < k <= n:
        raise ValueError(f"k={k} outside [1, {n}]")
    if not emb.is_cuda:
        return dense_topk_ref(emb, qvec, base, k=k)
    if not kernel_native(k):
        raise ValueError(f"k={k} > {MAX_KERNEL_K}: the dense-scoring kernel "
                         f"serves k <= {MAX_KERNEL_K}")
    tensors = [emb, qvec] + ([] if base is None else [base])
    if any(t.device != emb.device for t in tensors):
        raise ValueError("emb, qvec and base must lie on one device")
    dev = emb.device
    emb = emb.to(torch.float32).contiguous()
    q = qvec.to(torch.float32).contiguous()
    if base is not None:
        base = base.to(torch.float32).contiguous()
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, idxs
    shared = emb.dim() == 2
    group = min(nq, MAX_GROUP) if shared else 1
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_seg, seg_len, tile = plan(nq, n, k, group, n_sm)
    cand_vals = torch.empty((nq, n_seg, k), dtype=torch.float32, device=dev)
    cand_idxs = torch.empty((nq, n_seg, k), dtype=torch.int32, device=dev)
    err = _build.library().repro_dense_topk(
        emb.data_ptr(), 0 if shared else n * dim, q.data_ptr(),
        None if base is None else base.data_ptr(), nq, n, dim, k, group,
        n_seg, seg_len, tile, cand_vals.data_ptr(), cand_idxs.data_ptr(),
        vals.data_ptr(), idxs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "repro_dense_topk")
    streaming_dense_topk.launches += 1
    return vals, idxs


streaming_dense_topk.launches = 0
