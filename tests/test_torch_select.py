"""The warp select of ``csrc/topk_block.cuh`` (k <= 128), which the top-k,
dense-scoring and PQ-scoring kernels take their top-k with, against the JAX
package on the CPU.

The kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions.  Here a numpy model, kept in this file and
off the main path, follows the CUDA code step by step: the 64-bit key
(order_key(value) << 32 | ~index, -0.0 just below +0.0), the 32 lanes of a
warp, each lane's thread queue of THREAD_Q keys (newest first), the
batches of WARP_UNROLL loads held against the warp's k-th value, the slow
path that offers a batch's elements one at a time, the queue-full vote,
the bitonic sort of each thread-queue slot across the lanes, its insertion
into the warp queue of 32 * WQ keys (WQ = 1, 2 or 4 a lane: its last slot,
then a bitonic merge across the slots and the lanes), the k-th key
broadcast, the pairwise merge of the block's warp queues through shared
memory, the (-inf, INT_MAX) pads of a short segment, and the second stage,
which merges the segments' candidate lists through their indices.  The
segments are planned by the wrappers' own planners for an H100's 132 SMs.
The model must equal ``streaming_topk_ref`` and ``lax.top_k`` in values
and indices; the dense kernel's model, which also repeats its fp32 dot
products (multiply, then add, d = 0..dim-1, then + base), must agree with
both packages' plain versions; the PQ kernel's model (its scoring order,
each CTA's tiles and select, the first CTA's merge of the cluster's
queues) must equal both packages' plain versions."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.dense_scoring.ref import dense_topk_ref as jax_dense_ref
from repro.kernels.pq_scoring.ref import pq_topk_ref as jax_pq_ref
from repro_torch.common import cdiv
from repro_torch.common import order_key as common_order_key
from repro_torch.common import topk as common_topk
from repro_torch.kernels.dense_scoring import ops as dense_ops
from repro_torch.kernels.dense_scoring.ref import dense_topk_ref
from repro_torch.kernels.pq_scoring import ops as pq_ops
from repro_torch.kernels.pq_scoring.ref import pq_topk_ref
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.kernels.topk.ref import streaming_topk_ref

N_SM = 132              # an H100's SMs, as the wrappers read them
MAX_WQ = 4              # topk_block.cuh: MAX_WQ, THREAD_Q, WARP_UNROLL
THREAD_Q = 2
WARP_UNROLL = 8
TOPK_THREADS = 512      # topk.cu: THREADS, MERGE_THREADS
MERGE_THREADS = 256
DENSE_THREADS = 512     # dense_topk.cu: THREADS
PQ_THREADS = 256        # pq_topk.cu: THREADS
PAD_KEY = np.uint64(0x007FFFFF80000000)
NEG_ZERO_KEY = np.uint32(0x7FFFFFFF)   # order_key(-0.0)
LANES = np.arange(32)
NEG = np.float32(-3.0e38)


def warp_slots(k):
    """The warp queue's keys a lane for k: 1, 2 or 4."""
    return 1 if k <= 32 else 2 if k <= 64 else 4


# -- the key ---------------------------------------------------------------

def order_key(v):
    """float32 -> uint32, larger float to larger key, -0.0 just below
    +0.0."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u,
                    u | np.uint32(0x80000000)).astype(np.uint32)


def make_key(v, idx):
    low = (~np.asarray(idx, np.int32)).view(np.uint32)
    return (order_key(v).astype(np.uint64) << np.uint64(32)) | \
        low.astype(np.uint64)


def key_value(key):
    hi = (np.asarray(key, np.uint64) >> np.uint64(32)).astype(np.uint32)
    u = np.where(hi & np.uint32(0x80000000), hi ^ np.uint32(0x80000000), ~hi)
    return u.astype(np.uint32).view(np.float32)


def key_index(key):
    low = (np.asarray(key, np.uint64) & np.uint64(0xFFFFFFFF))
    return (~low.astype(np.uint32)).view(np.int32)


# -- one warp: lanes are the last axis, a shuffle is an index by lane ------

def warp_sort_ascending(x):
    for size in (2, 4, 8, 16, 32):
        stride = size // 2
        while stride:
            y = x[LANES ^ stride]
            take_min = ((LANES & stride) == 0) == ((LANES & size) == 0)
            x = np.where(take_min, np.minimum(x, y), np.maximum(x, y))
            stride //= 2
    return x


def warp_merge_descending(x):
    for stride in (16, 8, 4, 2, 1):
        y = x[LANES ^ stride]
        x = np.where((LANES & stride) == 0, np.maximum(x, y),
                     np.minimum(x, y))
    return x


def queue_merge_descending(q):
    """A bitonic queue q [WQ, 32] (rank 32 t + l at q[t, l]) sorted
    descending: compare-exchanges between a lane's slots, then shuffles
    within each slot."""
    q = q.copy()
    s = len(q) // 2
    while s:
        for t in range(len(q)):
            if t & s == 0:
                a, b = q[t].copy(), q[t + s].copy()
                q[t], q[t + s] = np.maximum(a, b), np.minimum(a, b)
        s //= 2
    return np.stack([warp_merge_descending(x) for x in q])


def queue_insert(q, x):
    """32 keys x into the descending queue q, which keeps its top 32 * WQ:
    into its last slot, then (WQ > 1) that slot reversed and the queue
    merged."""
    q = q.copy()
    q[-1] = warp_merge_descending(np.maximum(q[-1], warp_sort_ascending(x)))
    if len(q) > 1:
        q[-1] = q[-1][31 - LANES]                      # __shfl_sync
        q = queue_merge_descending(q)
    return q


def queue_at(q, r):
    return q[r >> 5][r & 31]


def queue_sort_descending(q):
    """32 * WQ keys in any order (WQ = 2 or 4) sorted into the queue's
    order: slots sorted descending and ascending in turn, merged in pairs
    (the second pair reversed to ascending), then merged whole."""
    q = q.copy()
    q[0] = ~warp_sort_ascending(~q[0])
    q[1] = warp_sort_ascending(q[1])
    if len(q) == 4:
        q[2] = ~warp_sort_ascending(~q[2])
        q[3] = warp_sort_ascending(q[3])
        for a, b in ((0, 1), (2, 3)):
            q[a], q[b] = np.maximum(q[a], q[b]), np.minimum(q[a], q[b])
        q = np.stack([warp_merge_descending(x) for x in q])
        q[2], q[3] = q[3][31 - LANES].copy(), q[2][31 - LANES].copy()
    return queue_merge_descending(q)


class WarpSelect:
    """One warp: its warp queue, thread queues, bar and counts of what it
    did.  ``run`` is the one-slot list standing for the bar in shared
    memory of the block's warps that work on one row."""

    def __init__(self, k, run):
        self.k, self.run = k, run
        self.wq = np.full((warp_slots(k), 32), PAD_KEY)
        self.tq = np.full((THREAD_Q, 32), PAD_KEY)
        self.bar = PAD_KEY
        self.bar_value = np.float32(-np.inf)
        self.n_tq = np.zeros(32, np.int64)
        self.merges = self.slow_batches = 0

    def raise_bar(self, key):
        if key > self.bar:
            self.bar, self.bar_value = key, key_value(key)

    def publish(self):
        kth = queue_at(self.wq, self.k - 1)            # __shfl_sync
        self.raise_bar(kth)
        if kth != PAD_KEY:                             # atomicMax
            self.run[0] = max(self.run[0], kth)

    def merge(self):
        for t in range(THREAD_Q):
            if (self.tq[t] != PAD_KEY).any():          # __any_sync
                self.wq = queue_insert(self.wq, self.tq[t])
                self.tq[t] = PAD_KEY
        self.n_tq[:] = 0
        self.publish()
        self.merges += 1

    def offer(self, admit, key):
        take = admit & (key > self.bar)
        self.tq[1:, take] = self.tq[:-1, take]         # newest first
        self.tq[0, take] = key[take]
        self.n_tq += take
        if (self.n_tq == THREAD_Q).any():              # the queue-full vote
            self.merge()


def load_batch(n, base, stride, value):
    """A warp's batch at ``base``: WARP_UNROLL 32-wide tiles ``stride``
    apart, (u, lane) -> (index i, whether i < n, value)."""
    i = base + np.arange(WARP_UNROLL)[:, None] * stride + LANES
    valid = i < n
    return i, valid, np.where(valid, value(np.minimum(i, n - 1)),
                              np.float32(0))


def offer_batch(ws, n, i, valid, v, first, value, index, ascending):
    """The bar test of a batch, then the slow path where a lane hits."""
    ws.raise_bar(ws.run[0])
    # strict where indices grow past the bar's, unless the bar is -0.0
    strict = ascending and key_index(ws.bar) < index(np.asarray(i[0, 0])) \
        and (ws.bar >> np.uint64(32)) != NEG_ZERO_KEY
    hit = (v > ws.bar_value) | ((not strict) & (v == ws.bar_value))
    hits = valid & (np.arange(WARP_UNROLL)[:, None] != first) & hit
    if hits.any():                                     # the slow path
        ws.slow_batches += 1
        for u in np.flatnonzero(hits.any(axis=1)):     # __reduce_or_sync
            j = np.minimum(i[u], n - 1)
            key = np.where(hits[u], make_key(value(j), index(j)), PAD_KEY)
            ws.offer(hits[u], key)


def warp_stream(ws, n, part, parts, start, value, index, ascending,
                seeded=None):
    """The warp's batches from ``start`` on, passing over each lane's
    ``seeded`` element: a generator that stops after each batch, so that
    the warps of a block can take turns."""
    stride = parts * 32
    step = stride * WARP_UNROLL
    seeded = np.full(32, -1) if seeded is None else seeded
    for base in range(start, n, step):
        mine = (seeded >= base) & (seeded < base + step)
        first = np.where(mine, (seeded - base) // stride, -1)
        offer_batch(ws, n, *load_batch(n, base, stride, value), first, value,
                    index, ascending)
        yield


def take_turns(streams):
    """Run the warps' streams a batch each in turn (the card interleaves
    them in some order; the result does not depend on it)."""
    streams = list(streams)
    while streams:
        streams = [st for st in streams if next(st, StopIteration)
                   is not StopIteration]


def block_stream(sels, run, rows, seed_batches):
    """block_stream: ``rows[w]`` = (n, value, index, ascending) of warp w,
    part ``w % run`` of its run.  Every lane's largest value among its
    first ``seed_batches`` batches (the first on ties) enters its warp's
    queue; the k-th of each run's merged seeds is the run's bar (a
    barrier); then the warps stream from their first batch on, in turns,
    passing over the seeded elements.  With a queue of 2 or 4 slots and no
    warp's row longer than that many of its tiles (a block-wide vote), each
    warp's share is sorted into its queue whole instead."""
    wq, stride = len(sels[0].wq), run * 32
    if wq > 1 and all(r[0] <= stride * wq for r in rows):
        for w, ws in enumerate(sels):
            n, value, index, _ = rows[w]
            i = w % run * 32 + np.arange(wq)[:, None] * stride + LANES
            j = np.clip(i, 0, max(n - 1, 0))
            ws.wq = queue_sort_descending(
                np.where(i < n, make_key(value(j), index(j)), PAD_KEY)
                if n else np.full((wq, 32), PAD_KEY))
            ws.publish()
        return
    seededs = []
    for w, ws in enumerate(sels):
        n, value, index, _ = rows[w]
        part = w % run
        seeded = np.full(32, -1)
        top = np.zeros(32, np.float32)
        for b in range(seed_batches):
            base = part * 32 + b * run * 32 * WARP_UNROLL
            if base >= n:
                break
            i, valid, v = load_batch(n, base, run * 32, value)
            for u in range(WARP_UNROLL):
                take = valid[u] & ((seeded < 0) | (v[u] > top))
                top = np.where(take, v[u], top)
                seeded = np.where(take, i[u], seeded)
        at = np.clip(seeded, 0, max(n - 1, 0))
        seed = np.where(seeded >= 0, make_key(top, index(at)), PAD_KEY)
        ws.wq = queue_insert(ws.wq, seed)
        seededs.append(seeded)
    merged = block_merge_queues(np.stack([ws.wq for ws in sels]), run)
    for w in range(0, len(sels), run):
        kth = queue_at(merged[w], sels[w].k - 1)
        if kth != PAD_KEY:
            sels[w].run[0] = kth
    take_turns(warp_stream(ws, rows[w][0], w % run, run, w % run * 32,
                           *rows[w][1:], seeded=seededs[w])
               for w, ws in enumerate(sels))


def ascending_from(offset):
    return lambda j: (offset + np.asarray(j)).astype(np.int32)


def block_merge_queues(queues, run):
    """queues [warps, WQ, 32] -> the merged queue of each run of ``run``
    warps, in the run's first warp: a queue against its partner's read
    backwards (rank 32 t + l against 32 (WQ - 1 - t) + 31 - l)."""
    q = queues.copy()
    span = 1
    while span < run:
        sq = q.copy()                                  # shared memory
        for w in range(len(q)):
            if w & (2 * span - 1) == 0:
                q[w] = queue_merge_descending(
                    np.maximum(q[w], sq[w + span][::-1, ::-1]))
        span *= 2
    return q


def block_warp_topk(n, k, value, index, threads, ascending):
    warps = threads // 32
    bar = [PAD_KEY]
    sels = [WarpSelect(k, bar) for _ in range(warps)]
    block_stream(sels, warps, [(n, value, index, ascending)] * warps,
                 seed_batches=1)
    for ws in sels:
        ws.merge()
    top = block_merge_queues(np.stack([ws.wq for ws in sels]),
                             warps)[0].reshape(-1)
    return key_value(top[:k]), key_index(top[:k]), sels


def merge_stage(cand_v, cand_i, k):
    """topk.cu's merge kernel: each row's candidate lists by warp select,
    each candidate's index read through src_idx (not ascending)."""
    out = [block_warp_topk(c.shape[0], k, lambda i, c=c: c[i],
                           lambda i, d=d: d[i], MERGE_THREADS, False)[:2]
           for c, d in zip(cand_v, cand_i)]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def topk_model(scores, k):
    """csrc/topk.cu: scores [nq, n] f32 -> (vals, idxs)."""
    nq, n = scores.shape
    n_seg, seg_len = topk_ops.plan(nq, n, k, N_SM)
    cand_v = np.zeros((nq, n_seg * k), np.float32)
    cand_i = np.zeros((nq, n_seg * k), np.int32)
    for q in range(nq):
        for s in range(n_seg):
            lo = s * seg_len
            row = scores[q, lo:lo + seg_len]
            v, i, _ = block_warp_topk(row.shape[0], k, lambda j: row[j],
                                      ascending_from(lo), TOPK_THREADS,
                                      True)
            cand_v[q, s * k:(s + 1) * k] = v
            cand_i[q, s * k:(s + 1) * k] = i
    if n_seg == 1:
        return cand_v, cand_i
    return merge_stage(cand_v, cand_i, k)


def dense_scores_model(emb, qvec, base):
    """The kernel's fp32 dot products: multiply, then add, d = 0..dim-1,
    then + base; emb [n, dim] or [nq, n, dim] -> [nq, n]."""
    e = np.broadcast_to(emb, (qvec.shape[0],) + emb.shape[-2:])
    acc = np.zeros(e.shape[:2], np.float32)
    for d in range(e.shape[2]):
        acc = acc + e[:, :, d] * qvec[:, d:d + 1]
    return acc if base is None else acc + base


def dense_model(emb, qvec, base, k, n_sm=N_SM):
    """csrc/dense_topk.cu on a card of ``n_sm`` SMs: the group's warps
    split the score rows of each tile, 16 / G a query, with queues kept
    across tiles."""
    nq = qvec.shape[0]
    n = emb.shape[-2]
    shared = emb.ndim == 2
    group = min(nq, dense_ops.MAX_GROUP) if shared else 1
    G = 1 if group == 1 else 4 if group <= 4 else 8
    run = DENSE_THREADS // 32 // G
    n_seg, seg_len, tile = dense_ops.plan(nq, n, k, group, n_sm)
    scores = dense_scores_model(emb, qvec, base)
    n_groups = cdiv(nq, group)
    cand_v = np.zeros((nq, n_seg * k), np.float32)
    cand_i = np.zeros((nq, n_seg * k), np.int32)
    for s in range(n_seg):
        lo = s * seg_len
        length = min(seg_len, n - lo)
        for grp in range(n_groups):
            q0 = grp * group
            g_n = min(group, nq - q0)
            bars = [[PAD_KEY] for _ in range(G)]
            sels = [WarpSelect(k, bars[w // run])
                    for w in range(DENSE_THREADS // 32)]
            for t0 in range(0, length, tile):            # __syncthreads
                t_len = min(tile, length - t0)
                rows = [(t_len if w // run < g_n else 0,
                         lambda i, r=scores[min(q0 + w // run, nq - 1),
                                            lo + t0:]: r[i],
                         ascending_from(lo + t0), True)
                        for w in range(len(sels))]
                if t0 == 0:      # the first tile seeds, all of it
                    block_stream(sels, run, rows, seed_batches=1 << 20)
                else:
                    take_turns(warp_stream(ws, *rows[w][:1], w % run, run,
                                           w % run * 32, *rows[w][1:])
                               for w, ws in enumerate(sels))
                for ws in sels:          # flushed at the end of each tile
                    ws.merge()
            top = block_merge_queues(np.stack([ws.wq for ws in sels]), run)
            for g in range(g_n):
                out = top[g * run].reshape(-1)[:k]
                cand_v[q0 + g, s * k:(s + 1) * k] = key_value(out)
                cand_i[q0 + g, s * k:(s + 1) * k] = key_index(out)
    if n_seg == 1:
        return cand_v, cand_i
    return merge_stage(cand_v, cand_i, k)


# -- the rows --------------------------------------------------------------

def make_row(kind, nq, n, k, rng):
    if kind == "equal":
        return np.full((nq, n), 1.5, np.float32)
    if kind == "pm_zero":
        return np.where(rng.random((nq, n)) < 0.5, np.float32(-0.0),
                        np.float32(0.0)).astype(np.float32)
    if kind == "neginf_fewer_than_k":
        s = np.full((nq, n), -np.inf, np.float32)
        for q in range(nq):
            at = rng.choice(n, size=max(0, min(n, k) - 1), replace=False)
            s[q, at] = rng.standard_normal(len(at))
        return s
    if kind == "ascending":
        return np.broadcast_to(np.arange(n, dtype=np.float32),
                               (nq, n)).copy()
    if kind == "descending":
        return np.broadcast_to(-np.arange(n, dtype=np.float32),
                               (nq, n)).copy()
    if kind == "small_ints":
        return rng.integers(0, 5, (nq, n)).astype(np.float32)
    return rng.standard_normal((nq, n)).astype(np.float32)


def lax_top_k(scores, k):
    v, i = jax.vmap(lambda r: jax.lax.top_k(r, k))(jnp.asarray(scores))
    return np.asarray(v), np.asarray(i)


KINDS = ["equal", "pm_zero", "neginf_fewer_than_k", "ascending",
         "descending", "small_ints", "random"]


# (rows, length): shorter than 32; shorter than a segment and not a
# multiple of 32; several segments of a length that is not a multiple of 32
# or 512 (2 x 20001 -> 4 segments of 5001); D4's shortlist rows (16 x 6888,
# one segment); k up to the length, on both sides of each warp queue's size
SHAPES_K = [(nq, n, k) for nq, n in [(2, 20), (3, 1000), (2, 20001)]
            for k in (1, 8, 10, 31, 32, 33, 64, 80, 128) if k <= n]
SHAPES_K += [(16, 6888, k) for k in (10, 33, 80, 128)]


@pytest.mark.parametrize("nq,n,k", SHAPES_K)
@pytest.mark.parametrize("kind", KINDS)
def test_topk_model_equals_plain_and_lax(nq, n, k, kind):
    rng = np.random.default_rng(n * 64 + k)
    s = make_row(kind, nq, n, k, rng)
    v, i = topk_model(s, k)
    pv, pi = streaming_topk_ref(torch.from_numpy(s), k=k)
    lv, li = lax_top_k(s, k)
    np.testing.assert_array_equal(i, pi.numpy())
    np.testing.assert_array_equal(v.view(np.uint32), pv.numpy().view(np.uint32))
    np.testing.assert_array_equal(v.view(np.uint32), lv.view(np.uint32))
    np.testing.assert_array_equal(i, li)


def test_topk_model_takes_the_paths_it_should():
    """An ascending row sends every batch after the seeded first one down
    the slow path and merges as it goes; a row of ties takes the slow path
    once (the warp whose first batch holds the bar's element: the test is
    strict everywhere else) and merges only at the end; on random rows the
    bar seeded from the block's 512 lane maxima keeps most batches on the
    fast path.  The second stage runs over
    16 segments a row at RQ1's chunk of 16 rows."""
    assert topk_ops.plan(16, 528155, 10, N_SM) == (16, 33010)
    n = 4 * TOPK_THREADS * WARP_UNROLL       # four batches a warp
    rng = np.random.default_rng(0)
    rows = {"ascending": np.arange(n, dtype=np.float32),
            "equal": np.full(n, 2.0, np.float32),
            "random": rng.standard_normal(n).astype(np.float32)}
    counts = {}
    for name, row in rows.items():
        _, idx, sels = block_warp_topk(n, 10, lambda j, r=row: r[j],
                                       ascending_from(0), TOPK_THREADS,
                                       True)
        counts[name] = (sum(ws.merges for ws in sels),
                        sum(ws.slow_batches for ws in sels))
        np.testing.assert_array_equal(
            idx, np.argsort(-row, kind="stable")[:10])
    warps = TOPK_THREADS // 32
    assert counts["ascending"][1] == warps * 3
    assert counts["ascending"][0] > 2 * warps
    assert counts["equal"] == (warps, 1)
    assert counts["random"][1] < warps * 3 * 2 // 3


# the last two: two SMs, so that a block's segment (5,000 rows) runs in
# three tiles of at most 2,048 rows and its queues wait between them
@pytest.mark.parametrize("nq,n,dim,shared,kind,k,n_sm",
                         [(3, 3000, 16, True, "random", 10, N_SM),
                          (12, 5000, 8, True, "random", 8, N_SM),
                          (8, 2500, 16, True, "small_ints", 10, N_SM),
                          (4, 1000, 16, False, "random", 8, N_SM),
                          (2, 700, 12, False, "small_ints", 32, N_SM),
                          (5, 40, 8, False, "random", 31, N_SM),
                          (8, 20000, 8, True, "random", 10, 2),
                          (8, 20000, 8, True, "small_ints", 32, 2),
                          (4, 1000, 16, False, "random", 80, N_SM),
                          (8, 20000, 8, True, "small_ints", 64, 2),
                          (3, 3000, 16, True, "small_ints", 128, N_SM)])
def test_dense_model_agrees_with_plain_and_jax(nq, n, dim, shared, kind, k,
                                               n_sm):
    rng = np.random.default_rng(nq * n + dim)
    lead = (n,) if shared else (nq, n)
    if kind == "small_ints":           # integer scores, many ties
        emb = rng.integers(-2, 3, lead + (dim,)).astype(np.float32)
        q = rng.integers(-2, 3, (nq, dim)).astype(np.float32)
        base = rng.integers(0, 3, (nq, n)).astype(np.float32)
    else:
        emb = rng.standard_normal(lead + (dim,)).astype(np.float32)
        q = rng.standard_normal((nq, dim)).astype(np.float32)
        base = rng.standard_normal((nq, n)).astype(np.float32)
    base = np.where(rng.random((nq, n)) < 0.2, NEG, base).astype(np.float32)
    if n_sm != N_SM:
        _, seg_len, tile = dense_ops.plan(nq, n, k, min(nq, 8), n_sm)
        assert seg_len > tile * 2                  # three tiles a segment
    v, i = dense_model(emb, q, base, k, n_sm)
    pv, pi = dense_topk_ref(torch.from_numpy(emb), torch.from_numpy(q),
                            torch.from_numpy(base), k=k)
    ej = emb if shared else None
    jv, ji = zip(*(jax_dense_ref(jnp.asarray(ej if shared else emb[r]),
                                 jnp.asarray(q[r]), jnp.asarray(base[r]),
                                 k=k) for r in range(nq)))
    jv, ji = np.stack(jv), np.stack(ji)
    if kind == "small_ints":            # integer scores: every order exact
        np.testing.assert_array_equal(v, pv.numpy())
        np.testing.assert_array_equal(i, pi.numpy())
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(i, ji)
        return
    np.testing.assert_allclose(v, pv.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    # equal docids, except where the reference's neighbours tie within the
    # tolerance (the dot products round in other orders)
    for ref_v, ref_i in ((pv.numpy(), pi.numpy()), (jv, ji)):
        for r, c in zip(*np.nonzero(i != ref_i)):
            near = [abs(ref_v[r, j] - ref_v[r, c]) <= 1e-5 + 1e-5 * abs(
                ref_v[r, c]) for j in (c - 1, c + 1) if 0 <= j < k]
            assert c == k - 1 or any(near), (r, c)
    # the selection itself is exact: the model's own scores, plain top-k
    mv, mi = streaming_topk_ref(torch.from_numpy(
        dense_scores_model(emb, q, base)), k=k)
    np.testing.assert_array_equal(v, mv.numpy())
    np.testing.assert_array_equal(i, mi.numpy())


# -- the PQ-scoring kernel -------------------------------------------------

def pq_scores_model(codes, table, base):
    """csrc/pq_topk.cu's scores: the m lookups added in subspace order, then
    + base, each add rounded to f32; codes [nq, n, m] -> [nq, n]."""
    q = np.arange(codes.shape[0])[:, None]
    acc = table[q, 0, codes[..., 0]]
    for s in range(1, codes.shape[2]):
        acc = (acc + table[q, s, codes[..., s]]).astype(np.float32)
    return acc if base is None else (acc + base).astype(np.float32)


def pq_model(codes, table, base, k, block=None):
    """csrc/pq_topk.cu: a cluster of C CTAs a query (the wrapper's plan,
    ``block`` capping its rows a tile), each a segment of seg_len rows in
    tiles; a CTA's warps run the warp select over each tile's scores (the
    first tile seeds the bar, the queues stay across tiles), merge their
    thread queues at the end, and the CTA's warp queues merge; then warp w
    of the first CTA takes CTA w's queue, and the first C warps' queues
    merge into [k]."""
    nq, n, m = codes.shape
    cluster, seg_len, tile = pq_ops.plan(n, m, table.shape[2], block)
    warps = PQ_THREADS // 32
    scores = pq_scores_model(codes, table, base)
    vals, idxs = [], []
    for q in range(nq):
        ctas = []
        for rank in range(cluster):
            lo = rank * seg_len
            length = max(0, min(seg_len, n - lo))
            bar = [PAD_KEY]
            sels = [WarpSelect(k, bar) for _ in range(warps)]
            for t0 in range(0, length, tile):
                t_len = min(tile, length - t0)
                row = scores[q, lo + t0:lo + t0 + t_len]
                rows = [(t_len, lambda j, r=row: r[j],
                         ascending_from(lo + t0), True)] * warps
                if t0 == 0:
                    block_stream(sels, warps, rows, seed_batches=1 << 20)
                else:
                    take_turns(warp_stream(ws, t_len, w, warps, w * 32,
                                           *rows[w][1:])
                               for w, ws in enumerate(sels))
            for ws in sels:
                ws.merge()
            ctas.append(block_merge_queues(
                np.stack([ws.wq for ws in sels]), warps)[0])
        pads = [np.full_like(ctas[0], PAD_KEY)] * (warps - cluster)
        top = block_merge_queues(np.stack(ctas + pads),
                                 cluster)[0].reshape(-1)[:k]
        vals.append(key_value(top))
        idxs.append(key_index(top))
    return np.stack(vals), np.stack(idxs)


def make_pq(kind, nq, n, m, rng):
    """(codes, table, base) of a PQ case: random tables with 10 % NEG
    bases; small-integer tables and bases (exact sums in any order); code
    words repeated (odd rows copy even ones: ties); one value in the whole
    table; a table of -0.0 with a few +0.0 entries."""
    codes = rng.integers(0, 256, (nq, n, m)).astype(np.uint8)
    base = None
    if kind in ("random", "dup_codes"):
        table = rng.standard_normal((nq, m, 256)).astype(np.float32)
        base = np.where(rng.random((nq, n)) < 0.1, NEG,
                        rng.standard_normal((nq, n))).astype(np.float32)
        if kind == "dup_codes":
            codes[:, 1::2] = codes[:, 0:n - 1:2]
    elif kind == "small_ints":
        table = rng.integers(-3, 4, (nq, m, 256)).astype(np.float32)
        base = rng.integers(0, 3, (nq, n)).astype(np.float32)
    elif kind == "equal":
        table = np.full((nq, m, 256), 0.25, np.float32)
    else:                                                  # pm_zero
        table = np.where(rng.random((nq, m, 256)) < 0.002, np.float32(0.0),
                         np.float32(-0.0)).astype(np.float32)
    return codes, table, base


# (queries, rows, m, kind, k): D4's chunk and shortlist (one 864-row tile a
# CTA), ties, one value, signed zeros, m = 8 (the kernel's byte loads),
# rows fewer than a CTA's 16 (empty CTAs), rows past two tiles a CTA (the
# ring of two slots, reused)
PQ_CASES = [(16, 6888, 16, "random", 10), (16, 6888, 16, "random", 80),
            (16, 6888, 16, "small_ints", 80), (4, 6888, 16, "dup_codes", 128),
            (3, 2000, 8, "equal", 80), (3, 2000, 8, "pm_zero", 80),
            (2, 100, 16, "random", 33), (5, 300, 8, "small_ints", 1),
            (1, 40000, 16, "small_ints", 64)]


@pytest.mark.parametrize("nq,n,m,kind,k", PQ_CASES)
def test_pq_model_equals_plain_and_jax(nq, n, m, kind, k):
    rng = np.random.default_rng(nq * n + m + k)
    codes, table, base = make_pq(kind, nq, n, m, rng)
    v, i = pq_model(codes, table, base, k)
    tb = None if base is None else torch.from_numpy(base)
    pv, pi = pq_topk_ref(torch.from_numpy(codes), torch.from_numpy(table),
                         tb, k=k)
    np.testing.assert_array_equal(i, pi.numpy())
    np.testing.assert_array_equal(v.view(np.uint32), pv.numpy().view(np.uint32))
    if kind == "pm_zero":
        # a sum of zeros keeps -0.0 only in the kernel's order (jnp.sum may
        # start from +0.0): held against lax.top_k of the same scores
        lv, li = lax_top_k(pq_scores_model(codes, table, base), k)
        np.testing.assert_array_equal(i, li)
        np.testing.assert_array_equal(v.view(np.uint32), lv.view(np.uint32))
        assert (np.signbit(v) & (v == 0)).any() and (~np.signbit(v)).any()
        return
    jv, ji = zip(*(jax_pq_ref(jnp.asarray(codes[r]), jnp.asarray(table[r]),
                              None if base is None else jnp.asarray(base[r]),
                              k=k) for r in range(nq)))
    jv, ji = np.stack(jv), np.stack(ji)
    if kind in ("small_ints", "equal"):          # exact sums: every order
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(i, ji)
        return
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    for r, c in zip(*np.nonzero(i != ji)):       # only inside a tie
        near = [abs(jv[r, j] - jv[r, c]) <= 1e-5 + 1e-5 * abs(jv[r, c])
                for j in (c - 1, c + 1) if 0 <= j < k]
        assert c == k - 1 or any(near), (r, c)


# (queries, rows, m, kind, k, block): D4's one-tile segments cut into two,
# four and 18 tiles (the pq_block knob's candidates and a small one), and
# long rows at other tiles than the largest that fits
PQ_BLOCK_CASES = [(2, 6888, 16, "random", 80, 432),
                  (2, 6888, 16, "dup_codes", 10, 216),
                  (1, 6888, 16, "small_ints", 128, 48),
                  (1, 40000, 16, "small_ints", 64, 1000)]


@pytest.mark.parametrize("nq,n,m,kind,k,block", PQ_BLOCK_CASES)
def test_pq_model_block_is_bit_equal(nq, n, m, kind, k, block):
    """Any tile the plan allows gives the default tile's result bit for
    bit: the warp queues and the bar carry over from tile to tile."""
    rng = np.random.default_rng(nq * n + m + k + block)
    codes, table, base = make_pq(kind, nq, n, m, rng)
    tile = pq_ops.plan(n, m, 256)[2]
    assert pq_ops.plan(n, m, 256, block)[2] < tile
    v0, i0 = pq_model(codes, table, base, k)
    v, i = pq_model(codes, table, base, k, block)
    np.testing.assert_array_equal(i, i0)
    np.testing.assert_array_equal(v.view(np.uint32), v0.view(np.uint32))


def test_pq_plan():
    """D4's chunk: clusters of 8 CTAs a query, 864 rows a CTA in one tile
    (16 x 8 = 128 CTAs); long rows stream through tiles that fit beside the
    table; segments and tiles are multiples of 16 rows."""
    assert pq_ops.plan(6888, 16, 256) == (8, 864, 864)
    # block: rounded up to 16 rows, capped by the segment and the shared
    # memory
    assert pq_ops.plan(6888, 16, 256, 400) == (8, 864, 400)
    assert pq_ops.plan(6888, 16, 256, 401) == (8, 864, 416)
    assert pq_ops.plan(6888, 16, 256, 5000) == (8, 864, 864)
    assert pq_ops.plan(40000, 16, 256, 10 ** 6) == pq_ops.plan(40000, 16, 256)
    with pytest.raises(ValueError, match="block"):
        pq_ops.plan(6888, 16, 256, 0)
    cluster, seg_len, tile = pq_ops.plan(40000, 16, 256)
    assert (cluster, seg_len) == (8, 5008) and tile < seg_len
    assert seg_len % 16 == 0 and tile % 16 == 0
    table_b = 16 * 256 * 4
    assert table_b + 2 * tile * 20 + 4 * tile <= pq_ops.DYN_SMEM_KB * 1024
    with pytest.raises(ValueError, match="no room"):
        pq_ops.plan(1000, 256, 256)


def test_dense_plan_and_tiles():
    """D2's chunk (16 queries over the shared store, k=10) runs one wave of
    2 groups x 132 segments, each scored in two tiles of at most 2,048 rows;
    a k past 32 (a warp queue of 64 or 128) plans the same segments."""
    assert dense_ops.plan(16, 528155, 10, 8, N_SM) == (132, 4002, 2048)
    assert dense_ops.plan(16, 528155, 80, 8, N_SM) == (132, 4002, 2048)


CSRC = Path(dense_ops.__file__).resolve().parents[2] / "csrc"


@pytest.mark.parametrize("source, name, value", [
    ("topk_block.cuh", "MAX_WQ", MAX_WQ),
    ("topk_block.cuh", "THREAD_Q", THREAD_Q),
    ("topk_block.cuh", "WARP_UNROLL", WARP_UNROLL),
    ("topk.cu", "THREADS", TOPK_THREADS),
    ("topk.cu", "MERGE_THREADS", MERGE_THREADS),
    ("dense_topk.cu", "THREADS", DENSE_THREADS),
    ("dense_topk.cu", "MAX_GROUP", dense_ops.MAX_GROUP),
    ("pq_topk.cu", "THREADS", PQ_THREADS),
    ("pq_topk.cu", "MAX_CLUSTER", pq_ops.CLUSTER),
    ("pq_topk.cu", "ROW_ALIGN", pq_ops.ROW_ALIGN),
    ("pq_topk.cu", "DYN_SMEM_KB", pq_ops.DYN_SMEM_KB),
])
def test_constants_match_the_cuda_sources(source, name, value):
    """The models and the wrappers' planners use the kernels' own
    constants: the wrappers plan the segments, tiles and clusters, and the
    C entries reject a plan that breaks their bounds."""
    text = (CSRC / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert found == [str(value)], (source, name, found)


finite32 = st.floats(allow_nan=False, width=32)
index = st.integers(0, 2**31 - 2)


@settings(max_examples=300, deadline=None)
@given(finite32, index, finite32, index)
def test_key_orders_pairs_as_lax_top_k(a, i, b, j):
    """(a, i) ranks before (b, j) under lax.top_k's rule — larger value,
    +0.0 before -0.0, or an equal value at a lower index — exactly when its
    key is larger, as the port's ``common.order_key`` orders them; the pad
    key lies below a real -inf's."""
    a, b = np.float32(a), np.float32(b)
    ka, kb = make_key(a, i), make_key(b, j)
    same = a.tobytes() == b.tobytes()
    first = a > b or (a == b and not same and not np.signbit(a)) or \
        (same and i < j)
    assert (ka > kb) == first
    assert (ka == kb) == (same and i == j)
    assert key_index(ka) == i
    assert key_value(ka).tobytes() == a.tobytes()
    ta, tb = (common_order_key(torch.tensor([x])).item() for x in (a, b))
    assert (ta > tb) == (a > b or (a == b and not same and
                                    not np.signbit(a)))
    assert (ta == tb) == same
    assert make_key(np.float32(-np.inf), i) > PAD_KEY
    assert make_key(np.float32(-np.inf), 2**31 - 1) == PAD_KEY
    assert key_index(PAD_KEY) == 2**31 - 1
    assert key_value(PAD_KEY) == -np.inf


@pytest.mark.parametrize("wq", [1, 2, 4])
def test_queue_networks_sort(wq):
    """The queue's networks on random keys with repeats: an insertion keeps
    the top 32 * WQ of the queue and the new keys, sorted; a whole sort
    (WQ = 2, 4) and the pairwise merge of two queues give the sorted top."""
    rng = np.random.default_rng(wq)
    keys = lambda *shape: rng.integers(0, 200, shape).astype(np.uint64)
    for _ in range(20):
        q = np.sort(keys(32 * wq))[::-1].reshape(wq, 32)
        x = keys(32)
        want = np.sort(np.concatenate([q.ravel(), x]))[::-1][:32 * wq]
        np.testing.assert_array_equal(queue_insert(q, x).ravel(), want)
        if wq > 1:
            y = keys(wq, 32)
            np.testing.assert_array_equal(queue_sort_descending(y).ravel(),
                                          np.sort(y.ravel())[::-1])
        a = np.sort(keys(2, 32 * wq), axis=1)[:, ::-1].reshape(2, wq, 32)
        want = np.sort(a.ravel())[::-1][:32 * wq]
        np.testing.assert_array_equal(block_merge_queues(a, 2)[0].ravel(),
                                      want)


@pytest.mark.parametrize("kind", ["zeros", "ties"])
def test_plain_topk_ranks_negative_zero_below_positive(kind):
    """``common.topk`` (the plain version of all three kernels) gives
    lax.top_k's order: -0.0 just below +0.0, the lowest index first among
    equal values."""
    rng = np.random.default_rng(3)
    if kind == "zeros":
        s = np.array([[-0.0, 0.0, -0.0, 0.0, 1.0]], np.float32)
    else:
        s = rng.choice(np.array([-0.0, 0.0, -1.0, 1.0], np.float32),
                       (4, 300))
    for k in (1, 3, s.shape[1]):
        v, i = common_topk(torch.from_numpy(s), k)
        lv, li = lax_top_k(s, k)
        np.testing.assert_array_equal(i.numpy(), li)
        np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                      lv.view(np.uint32))
