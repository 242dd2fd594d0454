"""Wrapper of the PQ/ADC-scoring kernel (``csrc/pq_topk.cu``).

For a CUDA tensor it launches the kernel, which serves ``k <=
MAX_KERNEL_K`` and raises for a larger k (the IR fusion pass lowers onto
the kernel only within that bound); for a CPU tensor it takes the plain
version.  There is no fallback from a failed launch, and none from a
cluster that cannot be scheduled: it raises.  ``streaming_pq_topk.launches``
counts kernel launches, and only those: one a call.  In a pricing run
(``kernels/pricing.py``) a call is priced by :func:`cost` and launches
nothing.
"""
from __future__ import annotations

import torch

from repro_torch.common import cdiv, round_up
from repro_torch.common import on_card
from repro_torch.kernels import _build
from repro_torch.kernels.pricing import priced, topk_outputs
from repro_torch.kernels.pq_scoring.ref import pq_topk_ref

MAX_KERNEL_K = 128
#: CTAs a query (``MAX_CLUSTER`` in ``csrc/pq_topk.cu``: the portable
#: maximum): 16 queries make 128 CTAs, one wave on an H100's 132 SMs
CLUSTER = 8
#: segments and tiles are cut at multiples of these rows, so that every
#: bulk copy of codes (m % 16 == 0) and base rows is on 16 bytes
ROW_ALIGN = 16
#: dynamic shared memory a CTA may ask for: the table, two tiles of codes
#: and base rows, a tile of scores
DYN_SMEM_KB = 200


def plan(n: int, m: int, n_codes: int,
         block: int | None = None) -> tuple[int, int, int]:
    """(CTAs a query, rows a CTA, rows a tile): the query's rows cut into
    CLUSTER segments, each streamed in tiles that fit the shared memory
    beside the table (two tiles and the scores of one).  The tile is the
    largest that fits, or ``block`` rows rounded up to ``ROW_ALIGN`` and
    capped by that; its size changes no result (the warp select keeps its
    queues from tile to tile)."""
    seg_len = round_up(cdiv(n, CLUSTER), ROW_ALIGN)
    free = DYN_SMEM_KB * 1024 - round_up(m * n_codes * 4, 16)
    fit = free // (2 * (m + 4) + 4) // ROW_ALIGN * ROW_ALIGN
    if fit < ROW_ALIGN:
        raise ValueError(f"a table of [{m}, {n_codes}] leaves no room in "
                         f"shared memory for the PQ-scoring kernel's tiles")
    tile = min(seg_len, fit)
    if block is not None:
        if block < 1:
            raise ValueError(f"block={block} rows: must be positive")
        tile = min(tile, round_up(int(block), ROW_ALIGN))
    return CLUSTER, seg_len, tile


def kernel_native(k: int) -> bool:
    """Whether the kernel serves this shortlist depth.  The IR fusion pass
    (core/passes.py) records this."""
    return k <= MAX_KERNEL_K


def cost(codes: torch.Tensor, table: torch.Tensor,
         base: torch.Tensor | None = None, *, k: int,
         block: int | None = None) -> tuple[float, float]:
    """(flops, bytes) of one call: the codes, tables and base read once,
    the k f32 values and int32 indices of each query written once, m adds
    a scored row."""
    nq, n, m = codes.shape
    read = codes.numel() + table.numel() * 4 + (
        0 if base is None else base.numel() * 4)
    return float(nq * n * m), float(read + nq * k * 8)


def _outputs(codes, table, base=None, *, k: int, block: int | None = None):
    return topk_outputs((codes.shape[0],), k, codes.shape[1], codes.device)


@priced(cost, _outputs)
def streaming_pq_topk(codes: torch.Tensor, table: torch.Tensor,
                      base: torch.Tensor | None = None, *, k: int,
                      block: int | None = None):
    """Top-``k`` of the ADC scores ``table[0, c_0] + ... + table[m-1,
    c_{m-1}] + base`` of each query's rows: values sorted descending (f32)
    and their int32 row indices, -0.0 below +0.0, ties to the lowest index
    (the ``lax.top_k`` rule; documents that share a code word tie).

    ``codes`` [NQ, N, m] uint8 (each code < n_codes), ``table``
    [NQ, m, n_codes], ``base`` [NQ, N] or None (0); ``block`` caps the
    rows of a tile (:func:`plan`), which changes no result."""
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
    # the kernel takes the table's query and subspace strides (the ADC
    # einsum leaves it [m, nq, n_codes] in memory), so only rows of codes
    # that are not contiguous are copied
    table = table.to(torch.float32)
    if table.stride(2) != 1:
        table = table.contiguous()
    if base is not None:
        base = base.to(torch.float32).contiguous()
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, idxs
    cluster, seg_len, tile = plan(n, m, n_codes, block)
    with on_card(dev):
        err = _build.library().repro_pq_topk(
            codes.data_ptr(), table.data_ptr(), table.stride(0),
            table.stride(1), None if base is None else base.data_ptr(), nq,
            n, m, n_codes, k, cluster, seg_len, tile, vals.data_ptr(),
            idxs.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "repro_pq_topk")
    streaming_pq_topk.launches += 1
    return vals, idxs


streaming_pq_topk.launches = 0
