"""Inverted + direct index as tensors on one device (padded CSR).

The inverted file stores postings term-major in flat arrays (CSR); posting
lists are additionally blocked at ``BLOCK`` granularity with per-block
maximum term frequency / minimum document length so the retriever can do
*block-max* pruning (dense block sweeps with block-granular skipping).

The direct (forward) index is the transpose, used by the doc-vectors
feature-extraction path [Asadi & Lin].  Each document's forward list is
sorted by term id (the build emits it that way), which the doc-vectors
extractor relies on to look query terms up by binary search.

``term_start``, ``cf`` and ``fwd_start`` stay int64 on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.index.corpus import Corpus
from repro_torch.obs.tracing import NOOP_TRACER

BLOCK = 128

#: the 11 index arrays, in the order the JAX index flattens them
ARRAY_NAMES = ("term_start", "doc_ids", "tfs", "block_max_tf",
               "block_min_dl", "doc_len", "df", "cf", "fwd_start",
               "fwd_terms", "fwd_tfs")
META_NAMES = ("n_docs", "vocab", "avg_doclen", "total_terms", "max_fwd_len")
_INT64 = frozenset({"term_start", "cf", "fwd_start"})


@dataclasses.dataclass
class InvertedIndex:
    # inverted file (term-major CSR, postings sorted by docid)
    term_start: torch.Tensor    # [V+1] int64
    doc_ids: torch.Tensor       # [P] int32
    tfs: torch.Tensor           # [P] int32
    # per-block metadata (block b covers postings [b*BLOCK, (b+1)*BLOCK))
    block_max_tf: torch.Tensor  # [P/BLOCK] int32
    block_min_dl: torch.Tensor  # [P/BLOCK] int32
    # document statistics
    doc_len: torch.Tensor       # [D] int32
    df: torch.Tensor            # [V] int32
    cf: torch.Tensor            # [V] int64 collection frequency
    # direct (forward) file
    fwd_start: torch.Tensor     # [D+1] int64
    fwd_terms: torch.Tensor     # [F] int32 unique terms per doc, sorted
    fwd_tfs: torch.Tensor       # [F] int32
    # static metadata
    n_docs: int
    vocab: int
    avg_doclen: float
    total_terms: int
    max_fwd_len: int            # max unique terms in any doc

    @property
    def stats(self) -> dict:
        return {"n_docs": self.n_docs, "avg_doclen": self.avg_doclen,
                "total_terms": self.total_terms, "vocab": self.vocab}

    @property
    def device(self) -> torch.device:
        return self.doc_ids.device

    def arrays(self) -> dict[str, torch.Tensor]:
        return {n: getattr(self, n) for n in ARRAY_NAMES}

    def nbytes(self) -> int:
        """Bytes the index holds on its device."""
        return sum(a.numel() * a.element_size() for a in self.arrays().values())


def _host_arrays(corpus: Corpus, stop_df_fraction: float):
    """The host numpy build: the 11 arrays and the static metadata."""
    D = corpus.n_docs
    doc_of_token = np.repeat(np.arange(D, dtype=np.int64),
                             np.diff(corpus.doc_start))
    terms = corpus.doc_terms.astype(np.int64)
    doc_len = np.diff(corpus.doc_start).astype(np.int32)

    # unique (term, doc) pairs with counts == postings
    keys = terms * D + doc_of_token
    del doc_of_token
    uniq, counts = np.unique(keys, return_counts=True)
    del keys
    p_term = (uniq // D).astype(np.int64)
    p_doc = (uniq % D).astype(np.int32)
    p_tf = counts.astype(np.int32)
    del uniq, counts

    V = corpus.vocab
    df = np.bincount(p_term, minlength=V).astype(np.int32)
    cf = np.bincount(terms, minlength=V).astype(np.int64)
    del terms

    # stopword removal (index-time): drop postings of ubiquitous terms
    stop = df > stop_df_fraction * D
    if stop.any():
        keep = ~stop[p_term]
        p_term, p_doc, p_tf = p_term[keep], p_doc[keep], p_tf[keep]
        df = np.where(stop, 0, df)

    # pad each posting list to a BLOCK multiple so block metadata is aligned
    padded_len = np.maximum((df + BLOCK - 1) // BLOCK, 0) * BLOCK
    term_start = np.zeros(V + 1, np.int64)
    np.cumsum(padded_len, out=term_start[1:])
    P = int(term_start[-1])
    doc_ids = np.full(P, -1, np.int32)
    tfs = np.zeros(P, np.int32)
    # scatter postings into padded layout
    src_start = np.zeros(V + 1, np.int64)
    np.cumsum(df, out=src_start[1:])
    offsets = np.arange(len(p_term), dtype=np.int64) - src_start[p_term]
    dst = term_start[p_term] + offsets
    doc_ids[dst] = p_doc
    tfs[dst] = p_tf

    # block metadata (padding rows: tf=0, dl=max -> upper bound 0)
    nb = P // BLOCK
    b_tf = tfs.reshape(nb, BLOCK)
    b_dl = np.where(doc_ids.reshape(nb, BLOCK) >= 0,
                    doc_len[np.maximum(doc_ids.reshape(nb, BLOCK), 0)],
                    np.iinfo(np.int32).max)
    block_max_tf = b_tf.max(axis=1).astype(np.int32)
    block_min_dl = b_dl.min(axis=1).astype(np.int32)

    # forward file from the same pairs (doc-major, term-sorted per doc)
    order = np.argsort(p_doc, kind="stable")
    f_doc = p_doc[order]
    fwd_terms = p_term[order].astype(np.int32)
    fwd_tfs = p_tf[order]
    fwd_counts = np.bincount(f_doc, minlength=D)
    fwd_start = np.zeros(D + 1, np.int64)
    np.cumsum(fwd_counts, out=fwd_start[1:])

    arrays = dict(term_start=term_start, doc_ids=doc_ids, tfs=tfs,
                  block_max_tf=block_max_tf, block_min_dl=block_min_dl,
                  doc_len=doc_len, df=df, cf=cf, fwd_start=fwd_start,
                  fwd_terms=fwd_terms, fwd_tfs=fwd_tfs)
    meta = dict(n_docs=D, vocab=V, avg_doclen=float(doc_len.mean()),
                total_terms=int(doc_len.sum()),
                max_fwd_len=int(fwd_counts.max()))
    return arrays, meta


def build_index(corpus: Corpus, *, stop_df_fraction: float = 0.1,
                device=None) -> InvertedIndex:
    """Host-side index construction (numpy), then tensors on ``device``
    (``None`` = the card; raises without one).

    Terms with df > ``stop_df_fraction``·D are stopwords and are removed at
    index time (standard Terrier/Anserini practice) — this also bounds the
    postings-gather width of the retrievers.
    """
    dev = resolve_device(device)
    arrays, meta = _host_arrays(corpus, stop_df_fraction)
    return index_from_arrays(arrays, meta, dev)


def index_from_arrays(arrays: dict[str, np.ndarray], meta: dict,
                      device) -> InvertedIndex:
    """An index from host arrays — for example another implementation's
    index taken through ``np.asarray`` — so two packages can run on the
    same index.  ``term_start``, ``cf`` and ``fwd_start`` are widened to
    int64, the rest stored as int32."""
    dev = resolve_device(device)
    tensors = {}
    for name in ARRAY_NAMES:
        dt = np.int64 if name in _INT64 else np.int32
        host = np.require(np.asarray(arrays[name]), dtype=dt,
                          requirements=("C", "W"))
        tensors[name] = torch.as_tensor(host, device=dev)
    return InvertedIndex(
        **tensors, n_docs=int(meta["n_docs"]), vocab=int(meta["vocab"]),
        avg_doclen=float(meta["avg_doclen"]),
        total_terms=int(meta["total_terms"]),
        max_fwd_len=int(meta["max_fwd_len"]))


def gather_postings(index: InvertedIndex, terms: torch.Tensor,
                    max_postings: int) -> dict[str, torch.Tensor]:
    """Gather padded postings for query ``terms`` [NQ, MAXQ].

    Returns dict with [NQ, MAXQ, max_postings] doc_ids/tfs/mask and
    per-term df/cf [NQ, MAXQ].  Masked postings point at doc 0 with tf 0.
    A ``sparse.gather`` span (a profiler range while one records).
    """
    with NOOP_TRACER.span("sparse.gather", "sparse"):
        t = terms.clamp(min=0).long()
        start = index.term_start[t]
        length = index.term_start[t + 1] - start
        ar = torch.arange(max_postings, device=terms.device)
        in_range = (ar < length[..., None]) & (terms >= 0)[..., None]
        pos = (start[..., None] + ar).clamp(max=index.doc_ids.shape[0] - 1)
        docs = torch.where(in_range, index.doc_ids[pos], -1)
        tf = torch.where(in_range, index.tfs[pos], 0)
        mask = in_range & (docs >= 0)
        return {"doc_ids": docs.clamp(min=0), "tfs": tf, "mask": mask,
                "df": index.df[t], "cf": index.cf[t]}
