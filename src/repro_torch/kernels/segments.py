"""How the top-k and dense-scoring kernels cut their rows.

Each kernel gives every row segment a block of its own, takes the
segment's top-k (``repro::segment_topk`` in ``csrc/topk_block.cuh``) and
merges the segments' candidate lists (``repro::launch_topk_merge``).  A
segment shorter than k (only the last of a row can be) pads its list with
(-inf, INT_MAX), which the merge never takes.
"""
from __future__ import annotations

from repro_torch.common import cdiv


def plan_segments(n_row_sets: int, n: int, k: int, n_sm: int, *,
                  min_len: int, one_wave: bool = False) -> tuple[int, int]:
    """(segments per row, segment length) for a kernel that gives each of
    ``n_row_sets`` row sets of ``n`` rows its own blocks: about two blocks
    per SM (with ``one_wave``, at most two, so that the grid runs in one
    wave of two blocks an SM), each segment at least ``max(k, min_len)``
    rows long (only the last may be shorter)."""
    per_set = (2 * n_sm // n_row_sets if one_wave
               else cdiv(2 * n_sm, n_row_sets))
    n_seg = max(1, min(per_set, n // max(k, min_len)))
    seg_len = cdiv(n, n_seg)
    return cdiv(n, seg_len), seg_len
