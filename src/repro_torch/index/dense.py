"""Dense (embedding) index: brute-force scoring + top-k, the IVF-flat ANN
layout, and the IVF-PQ compressed layout, batched over queries.

Document embeddings come from a deterministic random projection of the
forward file (content-correlated, no training), built with torch on the
index's device.  The coarse quantiser and the PQ codebooks are trained by
the JAX package's host k-means (numpy, copied here), so from equal
embeddings both packages build identical lists and codes.

Search comes in two strategies, as in ``index/retrieve.py``:

* ``*_topk``        — gather candidates, score with one matmul, the plain
                      top-k (``kernels/*/ref.py``).  The unfused path.
* ``*_topk_fused``  — the same candidates through the dense-scoring or
                      PQ-scoring kernel at the *cutoff* depth.  The target
                      of the IR lowering (core/passes.py).

Every search takes ``qvecs`` [NQ, dim] and returns (docids [NQ, k] int32,
scores [NQ, k]); a query's probe picks its own lists, so its candidate
block is gathered per query ([NQ, nprobe * max_list_len, ...]) with the
``NEG`` base masking the slots past each list's end.

IVF-PQ search is two-level: the ADC scores of the probed codes give a
shortlist of depth ``r``, which is re-scored exactly against the flat
(doc-id-ordered) float store, and the final top-k is taken from the exact
scores.

Doc-axis sharding (``shard_dense_index``, ``sharded_dense_topk``) cuts the
flat store into contiguous shards, takes each shard's top-k on the kernel
and merges them, bit-equal to the unsharded search.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common import resolve_device, topk
from repro_torch.index.inverted import InvertedIndex

#: mask score for padded / invalid candidate rows — the constant the
#: kernels' callers use, so fused and unfused paths rank identically
NEG = -3.0e38


@dataclasses.dataclass
class DenseIndex:
    emb: torch.Tensor       # [D, dim] f32, unit-normalised
    dim: int
    seed: int = 0           # of the projection; queries are projected alike


def projection(vocab: int, dim: int, seed: int, device) -> torch.Tensor:
    """The random projection [vocab, dim] f32: numpy's draws from ``seed``,
    as the JAX package makes them (torch's generator would draw others)."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((vocab, dim)).astype(np.float32) / np.sqrt(dim)
    return torch.as_tensor(proj.astype(np.float32), device=device)


def build_dense_index(index: InvertedIndex, dim: int = 64, seed: int = 0,
                      chunk: int = 1 << 21) -> DenseIndex:
    """Random-projection doc embeddings from the forward file, on the
    index's device: each entry's projection row scaled by ``log1p(tf)`` and
    added into its document, then each row normalised.

    The sum runs in entry order, as the reference's ``np.add.at`` adds:
    step j adds every document's j-th entry to its row (the documents
    longest first, so those with a j-th entry are a prefix), in pieces of
    at most ``chunk`` documents, which bound the gathered [chunk, dim]
    buffer.  No two rows of a step coincide, so the sum is the same
    sequence of float32 adds on the CPU and on the card, where
    ``index_add_``'s atomics add a document's entries in an order that
    changes from run to run."""
    dev = index.device
    proj = projection(index.vocab, dim, seed, dev)
    D = index.n_docs
    emb = torch.zeros((D, dim), dtype=torch.float32, device=dev)
    starts = index.fwd_start
    lens = starts[1:] - starts[:-1]
    order = torch.argsort(lens, descending=True, stable=True)
    # docs with a j-th entry, for each j
    have = D - np.cumsum(np.bincount(lens.cpu().numpy(), minlength=1))
    for j, n in enumerate(have.tolist()):
        for c in range(0, n, chunk):
            doc = order[c:min(c + chunk, n)]
            at = starts[doc] + j
            tf = index.fwd_tfs[at].to(torch.float32)
            emb[doc] += proj[index.fwd_terms[at].long()] * \
                torch.log1p(tf)[:, None]
    emb /= torch.linalg.norm(emb, dim=1, keepdim=True).clamp(min=1e-6)
    return DenseIndex(emb, dim, seed)


def dense_from_arrays(emb, device) -> DenseIndex:
    """A dense index from host embeddings [D, dim] — for example another
    implementation's, taken through ``np.asarray`` — so two packages can
    search the same embeddings."""
    host = np.require(np.asarray(emb), dtype=np.float32,
                      requirements=("C", "W"))
    return DenseIndex(torch.as_tensor(host, device=resolve_device(device)),
                      int(host.shape[1]))


def embed_queries(proj: torch.Tensor, terms: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Project sparse queries terms/weights [NQ, MAXQ] into the dense
    space: [NQ, dim], unit-normalised."""
    t = terms.clamp(min=0).long()
    w = weights * (terms >= 0)
    vec = torch.einsum("qld,ql->qd", proj[t], w)
    return vec / torch.linalg.norm(vec, dim=-1, keepdim=True).clamp(min=1e-6)


# ---------------------------------------------------------------------------
# IVF-flat ANN index (coarse k-means quantiser + list-ordered flat store)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IVFDenseIndex:
    """IVF-flat layout over a :class:`DenseIndex`: ``emb`` holds the
    embeddings reordered by list (``None`` for the skeleton of a PQ-only
    deployment, ``build_ivf_index(..., keep_flat=False)``), ``doc_ids[i]``
    the document of row ``i``, ``list_start`` the CSR offsets."""
    centroids: torch.Tensor         # [n_lists, dim] unit-normalised
    emb: torch.Tensor | None        # [D, dim] embeddings in list order
    doc_ids: torch.Tensor           # [D] int64 row -> document id
    list_start: torch.Tensor        # [n_lists + 1] int64 CSR offsets
    dim: int
    n_lists: int
    max_list_len: int


def default_n_lists(n_docs: int) -> int:
    """sqrt(D) coarse lists (the usual IVF operating point), capped so tiny
    corpora still get multi-document lists."""
    return int(max(1, min(4096, round(n_docs ** 0.5))))


def _coarse_quantise(emb: np.ndarray, n_lists: int, iters: int, seed: int,
                     chunk: int):
    """Spherical k-means skeleton shared by the IVF-flat and IVF-PQ builds
    (host numpy, the JAX package's code): centroids, the stable list-order
    permutation, and the CSR offsets."""
    D = emb.shape[0]
    rng = np.random.default_rng(seed)
    cent = emb[rng.choice(D, size=n_lists, replace=False)].copy()
    assign = np.zeros(D, np.int64)
    for it in range(max(1, iters)):
        for s in range(0, D, chunk):
            e = min(s + chunk, D)
            assign[s:e] = np.argmax(emb[s:e] @ cent.T, axis=1)
        sums = np.stack([np.bincount(assign, weights=emb[:, d],
                                     minlength=n_lists)
                         for d in range(emb.shape[1])], axis=1)
        sums = sums.astype(np.float32)
        norms = np.linalg.norm(sums, axis=1, keepdims=True)
        # an emptied list keeps its previous centroid (stays probeable)
        cent = np.where(norms > 1e-9, sums / np.maximum(norms, 1e-9), cent)
    for s in range(0, D, chunk):
        e = min(s + chunk, D)
        assign[s:e] = np.argmax(emb[s:e] @ cent.T, axis=1)
    order = np.argsort(assign, kind="stable").astype(np.int32)
    counts = np.bincount(assign, minlength=n_lists)
    list_start = np.zeros(n_lists + 1, np.int32)
    list_start[1:] = np.cumsum(counts, dtype=np.int64)
    return cent.astype(np.float32), order, list_start, counts


def ivf_from_arrays(*, centroids, doc_ids, list_start, emb=None,
                    device) -> IVFDenseIndex:
    """An IVF-flat index from host arrays (list-ordered ``emb`` or None) —
    for example another implementation's, taken through ``np.asarray``."""
    dev = resolve_device(device)
    cent = np.asarray(centroids, np.float32)
    starts = np.asarray(list_start, np.int64)
    return IVFDenseIndex(
        centroids=torch.as_tensor(cent, device=dev),
        emb=None if emb is None else dense_from_arrays(emb, dev).emb,
        doc_ids=torch.as_tensor(np.asarray(doc_ids, np.int64), device=dev),
        list_start=torch.as_tensor(starts, device=dev),
        dim=int(cent.shape[1]), n_lists=int(cent.shape[0]),
        max_list_len=int(np.diff(starts).max()))


def build_ivf_index(dense: DenseIndex, *, n_lists: int | None = None,
                    iters: int = 6, seed: int = 0, chunk: int = 1 << 16,
                    keep_flat: bool = True) -> IVFDenseIndex:
    """Spherical k-means over the doc embeddings (on the host) -> IVF-flat
    index on the embeddings' device.  ``keep_flat=False`` skips the
    list-ordered float copy (``emb=None``): the skeleton of a PQ-only
    deployment, whose exact re-scoring reads the doc-ordered store."""
    emb = dense.emb.cpu().numpy()
    D = emb.shape[0]
    n_lists = default_n_lists(D) if n_lists is None else int(n_lists)
    n_lists = max(1, min(n_lists, D))
    cent, order, list_start, _ = _coarse_quantise(emb, n_lists, iters, seed,
                                                  chunk)
    ivf = ivf_from_arrays(centroids=cent, doc_ids=order,
                          list_start=list_start, device=dense.emb.device)
    if keep_flat:
        ivf.emb = dense.emb[ivf.doc_ids]
    return ivf


def _ivf_probe(index, qvecs, *, nprobe: int):
    """The probe shared by the flat and PQ layouts: each query's ``nprobe``
    best lists, as each candidate slot's position into the list-ordered
    store [NQ, nprobe * L] (clamped to the last row) and a NEG-masked base
    [NQ, nprobe * L]."""
    _, lists = topk(qvecs @ index.centroids.T, nprobe)
    L = index.max_list_len
    start = index.list_start[lists]
    length = index.list_start[lists + 1] - start
    slot = torch.arange(L, device=qvecs.device)
    valid = slot < length[..., None]                      # [NQ, nprobe, L]
    pos = (start[..., None] + slot).clamp(max=index.doc_ids.shape[0] - 1)
    NQ = qvecs.shape[0]
    base = torch.where(valid, 0.0, NEG)
    return pos.reshape(NQ, -1), base.reshape(NQ, -1)


def _ivf_candidates(ivf: IVFDenseIndex, qvecs, *, nprobe: int):
    """Each query's candidate block: the embeddings of its ``nprobe`` best
    lists [NQ, nprobe * L, dim], the NEG-masked base, the positions."""
    if ivf.emb is None:
        raise ValueError(
            "IVF-flat search needs the list-ordered float store; this index "
            "was built with keep_flat=False (PQ-only skeleton)")
    pos, base = _ivf_probe(ivf, qvecs, nprobe=nprobe)
    return ivf.emb[pos], base, pos


def _pad_candidates(cand, base, pos, k: int):
    """Guarantee at least ``k`` candidate rows (tiny nprobe x short lists):
    padded rows score NEG and surface as docid -1 / -inf."""
    n = base.shape[1]
    if n >= k:
        return cand, base, pos
    pad = k - n
    extra = (0, 0) * (cand.dim() - 2)
    return (torch.nn.functional.pad(cand, (*extra, 0, pad)),
            torch.nn.functional.pad(base, (0, pad), value=NEG),
            torch.nn.functional.pad(pos, (0, pad)))


def _finish_search(ivf, pos, vals, idxs):
    ok = vals > NEG / 2
    docs = ivf.doc_ids[torch.gather(pos, 1, idxs.long())]
    return (torch.where(ok, docs, -1).to(torch.int32),
            torch.where(ok, vals, -torch.inf))


def ivf_retrieve_topk(ivf: IVFDenseIndex, qvecs, *, k: int, nprobe: int):
    """IVF probe + matmul scoring + plain top-k (the unfused path)."""
    from repro_torch.kernels.dense_scoring.ref import dense_topk_ref
    emb_c, base, pos = _pad_candidates(*_ivf_candidates(ivf, qvecs,
                                                        nprobe=nprobe), k)
    vals, idxs = dense_topk_ref(emb_c, qvecs, base, k=k)
    return _finish_search(ivf, pos, vals, idxs)


def ivf_retrieve_topk_fused(ivf: IVFDenseIndex, qvecs, *, k: int,
                            nprobe: int):
    """IVF probe through the dense-scoring kernel at the cutoff depth
    (``dense_retrieve % K`` lowered by the fusion pass)."""
    from repro_torch.kernels.dense_scoring.ops import streaming_dense_topk
    emb_c, base, pos = _pad_candidates(*_ivf_candidates(ivf, qvecs,
                                                        nprobe=nprobe), k)
    vals, idxs = streaming_dense_topk(emb_c, qvecs, base, k=k)
    return _finish_search(ivf, pos, vals, idxs)


def dense_retrieve_exact(dense: DenseIndex, qvecs, *, k: int):
    """Brute-force dense top-k over every document (nprobe=0 mode)."""
    from repro_torch.kernels.dense_scoring.ref import dense_topk_ref
    vals, idxs = dense_topk_ref(dense.emb, qvecs, None, k=k)
    return idxs, vals


def dense_retrieve_exact_fused(dense: DenseIndex, qvecs, *, k: int):
    """Brute-force dense top-k through the dense-scoring kernel, which
    reads the shared store once for the whole query chunk."""
    from repro_torch.kernels.dense_scoring.ops import streaming_dense_topk
    vals, idxs = streaming_dense_topk(dense.emb, qvecs, None, k=k)
    return idxs, vals


# ---------------------------------------------------------------------------
# Product quantisation (PQ): per-subspace codebooks + uint8 codes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PQCodebook:
    """Per-subspace k-means codebooks: ``m`` contiguous subspaces of
    ``dsub = dim // m`` dims, each quantised against ``n_codes`` (<= 256,
    so codes fit uint8) centroids."""
    codebooks: torch.Tensor     # [m, n_codes, dsub] f32
    m: int
    dsub: int
    n_codes: int


def _pq_train(emb: np.ndarray, m: int, iters: int, seed: int, sample: int,
              chunk: int) -> np.ndarray:
    """The JAX package's host k-means per subspace -> codebooks
    [m, n_codes, dsub]."""
    D, dim = emb.shape
    dsub = dim // m
    n_codes = int(min(256, D))
    rng = np.random.default_rng(seed)
    train = emb if D <= sample else emb[rng.choice(D, size=sample,
                                                   replace=False)]
    T = train.shape[0]
    books = np.zeros((m, n_codes, dsub), np.float32)
    for s in range(m):
        X = np.ascontiguousarray(train[:, s * dsub:(s + 1) * dsub])
        cent = X[rng.choice(T, size=n_codes, replace=False)].copy()
        assign = np.zeros(T, np.int64)
        for _ in range(max(1, iters)):
            c2 = np.sum(cent * cent, axis=1)
            for lo in range(0, T, chunk):
                hi = min(lo + chunk, T)
                # argmin ||x - c||^2 == argmin (||c||^2 - 2 x.c)
                assign[lo:hi] = np.argmin(c2[None, :] - 2.0 * (X[lo:hi]
                                                               @ cent.T),
                                          axis=1)
            counts = np.bincount(assign, minlength=n_codes)
            sums = np.stack([np.bincount(assign, weights=X[:, d],
                                         minlength=n_codes)
                             for d in range(dsub)], axis=1).astype(np.float32)
            # an emptied code keeps its previous centroid
            nz = counts > 0
            cent[nz] = sums[nz] / counts[nz, None]
        books[s] = cent
    return books


def build_pq_codebook(emb: torch.Tensor, *, m: int = 8, iters: int = 10,
                      seed: int = 0, sample: int = 1 << 17,
                      chunk: int = 1 << 16) -> PQCodebook:
    """Train per-subspace k-means codebooks on the host (chunked, like the
    coarse quantiser); the codebooks land on ``emb``'s device."""
    D, dim = emb.shape
    m = int(m)
    if m < 1 or dim % m != 0:
        raise ValueError(f"m={m} must divide dim={dim}")
    books = _pq_train(emb.cpu().numpy(), m, iters, seed, sample, chunk)
    return PQCodebook(torch.as_tensor(books, device=emb.device), m,
                      dim // m, int(books.shape[1]))


def pq_encode(cb: PQCodebook, emb: torch.Tensor,
              chunk: int = 1 << 16) -> np.ndarray:
    """Quantise embeddings to uint8 codes [D, m] (host numpy, chunked)."""
    emb = emb.cpu().numpy()
    books = cb.codebooks.cpu().numpy()
    D = emb.shape[0]
    codes = np.zeros((D, cb.m), np.uint8)
    for s in range(cb.m):
        X = emb[:, s * cb.dsub:(s + 1) * cb.dsub]
        cent = books[s]
        c2 = np.sum(cent * cent, axis=1)
        for lo in range(0, D, chunk):
            hi = min(lo + chunk, D)
            codes[lo:hi, s] = np.argmin(c2[None, :] - 2.0 * (X[lo:hi]
                                                             @ cent.T),
                                        axis=1).astype(np.uint8)
    return codes


def pq_decode(cb: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct approximate embeddings [N, dim] from codes [N, m]."""
    idx = codes.long()
    return torch.cat([cb.codebooks[s][idx[:, s]] for s in range(cb.m)], 1)


def adc_table(cb: PQCodebook, qvecs: torch.Tensor) -> torch.Tensor:
    """Per-query asymmetric-distance lookup tables [NQ, m, n_codes]: entry
    ``(s, c)`` is the inner product of the query's s-th subvector with code
    ``c`` of subspace ``s``."""
    q = qvecs.reshape(qvecs.shape[0], cb.m, cb.dsub)
    return torch.einsum("mcd,qmd->qmc", cb.codebooks, q)


# ---------------------------------------------------------------------------
# IVF-PQ: uint8 codes in list order behind the same CSR layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IVFPQIndex:
    """IVF-PQ layout: the float list store of :class:`IVFDenseIndex`
    replaced by uint8 ``codes`` (list order, same CSR offsets).  ``emb`` is
    the *flat* (doc-id-ordered) float store of the source
    :class:`DenseIndex` — a reference, not a copy — that backs the exact
    re-scoring of the shortlist; ``None`` keeps the ADC scores."""
    centroids: torch.Tensor         # [n_lists, dim]
    codes: torch.Tensor             # [D, m] uint8, list order
    doc_ids: torch.Tensor           # [D] int64 row -> document id
    list_start: torch.Tensor        # [n_lists + 1] int64 CSR offsets
    codebook: PQCodebook
    emb: torch.Tensor | None        # [D, dim] f32, DOC-ID order
    dim: int
    n_lists: int
    max_list_len: int

    @property
    def m(self) -> int:
        return self.codebook.m


def ivfpq_from_arrays(*, centroids, codes, doc_ids, list_start, codebooks,
                      emb=None, device) -> IVFPQIndex:
    """An IVF-PQ index from host arrays (list-ordered ``codes``,
    ``codebooks`` [m, n_codes, dsub], doc-ordered ``emb`` or None)."""
    dev = resolve_device(device)
    ivf = ivf_from_arrays(centroids=centroids, doc_ids=doc_ids,
                          list_start=list_start, device=dev)
    books = np.asarray(codebooks, np.float32)
    m, n_codes, dsub = books.shape
    return IVFPQIndex(
        centroids=ivf.centroids,
        codes=torch.as_tensor(np.asarray(codes, np.uint8), device=dev),
        doc_ids=ivf.doc_ids, list_start=ivf.list_start,
        codebook=PQCodebook(torch.as_tensor(books, device=dev), m, dsub,
                            n_codes),
        emb=None if emb is None else dense_from_arrays(emb, dev).emb,
        dim=ivf.dim, n_lists=ivf.n_lists, max_list_len=ivf.max_list_len)


def pq_store_bytes(pq: IVFPQIndex) -> int:
    """Bytes of the PQ scoring store: codes + codebooks + coarse centroids
    (the flat re-score store is shared with the DenseIndex, not owned)."""
    return int(pq.codes.numel() * pq.codes.element_size()
               + pq.codebook.codebooks.numel() * 4
               + pq.centroids.numel() * 4)


def build_ivfpq_index(dense: DenseIndex, *, n_lists: int | None = None,
                      iters: int = 6, seed: int = 0, m: int = 8,
                      pq_iters: int = 10, chunk: int = 1 << 16,
                      keep_flat: bool = True,
                      ivf: IVFDenseIndex | None = None) -> IVFPQIndex:
    """Build an IVF-PQ index over a dense index.  Reuses an IVF skeleton
    when given, else builds one with ``keep_flat=False``.  ``keep_flat``
    here decides the exact re-score store: ``True`` shares ``dense.emb``,
    ``False`` keeps no float embeddings (ADC-only search)."""
    if ivf is None:
        ivf = build_ivf_index(dense, n_lists=n_lists, iters=iters, seed=seed,
                              chunk=chunk, keep_flat=False)
    cb = build_pq_codebook(dense.emb, m=m, iters=pq_iters, seed=seed,
                           chunk=chunk)
    codes = pq_encode(cb, dense.emb, chunk=chunk)
    order = ivf.doc_ids.cpu().numpy()
    return IVFPQIndex(
        centroids=ivf.centroids,
        codes=torch.as_tensor(codes[order], device=dense.emb.device),
        doc_ids=ivf.doc_ids, list_start=ivf.list_start, codebook=cb,
        emb=dense.emb if keep_flat else None, dim=dense.dim,
        n_lists=ivf.n_lists, max_list_len=ivf.max_list_len)


def _pq_finish(pq: IVFPQIndex, qvecs, pos_r, vals_a, *, k: int):
    """Exact float re-scoring of the ADC shortlist + final top-k.  With no
    float store the ADC scores stand."""
    ok = vals_a > NEG / 2
    docs = pq.doc_ids[pos_r]
    if pq.emb is not None:
        exact = torch.matmul(pq.emb[docs], qvecs[..., None])[..., 0]
        vals = torch.where(ok, exact, NEG)
    else:
        vals = torch.where(ok, vals_a, NEG)
    top_v, sel = topk(vals, k)
    ok_k = top_v > NEG / 2
    docs_k = torch.where(ok_k, torch.gather(docs, 1, sel), -1)
    return docs_k.to(torch.int32), torch.where(ok_k, top_v, -torch.inf)


def _pq_shortlist_depth(k: int, refine: int, n_cand: int) -> int:
    return max(k, min(int(refine) * k, n_cand))


def _pq_resolve_depth(k: int, refine: int, n_cand: int,
                      shortlist: int | None) -> int:
    """An explicit ``shortlist`` overrides the refine*k default — the
    fusion gate uses it to keep the *unfused* chain's shortlist depth
    (computed from the pre-cutoff k) so ``fused(K) == cutoff(unfused(k_in),
    K)`` holds exactly; clamped to [k, n_cand]."""
    if shortlist is None:
        return _pq_shortlist_depth(k, refine, n_cand)
    return max(k, min(int(shortlist), n_cand))


def _pq_candidates(pq: IVFPQIndex, qvecs, *, k: int, nprobe: int,
                   refine: int, shortlist: int | None):
    """Probe, shortlist depth, per-query tables and the gathered codes."""
    pos, base = _ivf_probe(pq, qvecs, nprobe=nprobe)
    r = _pq_resolve_depth(k, refine, pos.shape[1], shortlist)
    table = adc_table(pq.codebook, qvecs)
    codes_c, base, pos = _pad_candidates(pq.codes[pos], base, pos, r)
    return codes_c, table, base, pos, r


def ivfpq_retrieve_topk(pq: IVFPQIndex, qvecs, *, k: int, nprobe: int,
                        refine: int = 4, shortlist: int | None = None):
    """Two-level IVF-PQ search, unfused ADC stage: probe + code gather +
    table-lookup scoring + plain top-r shortlist, then exact float
    re-scoring of the shortlist."""
    from repro_torch.kernels.pq_scoring.ref import pq_topk_ref
    codes_c, table, base, pos, r = _pq_candidates(
        pq, qvecs, k=k, nprobe=nprobe, refine=refine, shortlist=shortlist)
    vals_a, idxs = pq_topk_ref(codes_c, table, base, k=r)
    return _pq_finish(pq, qvecs, torch.gather(pos, 1, idxs.long()), vals_a,
                      k=k)


def ivfpq_retrieve_topk_fused(pq: IVFPQIndex, qvecs, *, k: int, nprobe: int,
                              refine: int = 4, shortlist: int | None = None,
                              block: int | None = None):
    """Two-level IVF-PQ search with the ADC stage through the PQ-scoring
    kernel; ``block`` caps the kernel's rows a tile (no result changes)."""
    from repro_torch.kernels.pq_scoring.ops import streaming_pq_topk
    codes_c, table, base, pos, r = _pq_candidates(
        pq, qvecs, k=k, nprobe=nprobe, refine=refine, shortlist=shortlist)
    vals_a, idxs = streaming_pq_topk(codes_c, table, base, k=r, block=block)
    return _pq_finish(pq, qvecs, torch.gather(pos, 1, idxs.long()), vals_a,
                      k=k)


# ---------------------------------------------------------------------------
# Doc-axis sharding: per-shard top-k + cross-shard merge
# ---------------------------------------------------------------------------

def shard_dense_index(dense: DenseIndex, n_shards: int,
                      devices=None) -> list[tuple]:
    """Partition the document axis into ``n_shards`` contiguous slices.
    Returns ``(shard, offset)`` pairs; ``offset`` maps shard-local row ids
    back to global doc ids.  Contiguity is what makes the cross-shard merge
    tie-break identically to the single-index oracle (lower global id wins
    in both).

    Without ``devices`` each shard is a view of the store (no copy).  With
    ``devices``, the ``[data, docs]`` array of a ``("data", "docs")`` query
    mesh (``make_query_mesh(doc_shards=).devices``), shard *j* is placed on
    every card of doc group *j* (modulo the groups) as copies, a view
    cannot span cards: ``shard`` is then a tuple of DenseIndex, one a card
    of the group in ``data`` order.  Offsets stay global either way."""
    D = int(dense.emb.shape[0])
    n_shards = int(n_shards)
    if n_shards < 1 or n_shards > D:
        raise ValueError(f"n_shards={n_shards} outside [1, {D}]")
    cuts = [round(i * D / n_shards) for i in range(n_shards + 1)]
    views = [(dataclasses.replace(dense, emb=dense.emb[lo:hi]), lo)
             for lo, hi in zip(cuts[:-1], cuts[1:])]
    if devices is None:
        return views
    grid = np.asarray(devices, dtype=object)
    if grid.ndim != 2:
        raise ValueError(f"devices must be a [data, docs] array of a query "
                         f"mesh, got shape {grid.shape}")

    def copy(view, dev):
        dev = torch.device(dev)
        emb = (view.emb.clone() if view.emb.device == dev
               else view.emb.to(dev))
        return dataclasses.replace(view, emb=emb)

    return [(tuple(copy(view, d) for d in grid[:, j % grid.shape[1]]), lo)
            for j, (view, lo) in enumerate(views)]


def sharded_dense_topk(shards, qvecs, *, k: int):
    """Per-shard exact top-k through the dense-scoring kernel, then one
    merge through ``common.topk`` (qvecs [NQ, dim] -> docids [NQ, k] int32,
    scores [NQ, k]).

    Bit-identical to ``dense_retrieve_exact_fused`` on the unsharded
    index: a row's dot product does not depend on the other rows, each
    shard's top-k keeps ties in ascending local (= global, shards are
    contiguous) id order, and the merge's stable top-k over the
    shard-ordered concatenation therefore resolves ties to the lowest
    global doc id — exactly the oracle's rule."""
    docs_parts, vals_parts = [], []
    for shard, offset in shards:
        ks = min(k, int(shard.emb.shape[0]))
        d, v = dense_retrieve_exact_fused(shard, qvecs, k=ks)
        docs_parts.append(d + offset)
        vals_parts.append(v)
    vals = torch.cat(vals_parts, 1)
    docs = torch.cat(docs_parts, 1)
    top_v, sel = topk(vals, k)
    return torch.gather(docs, 1, sel).to(torch.int32), top_v
