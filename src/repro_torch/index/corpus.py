"""Synthetic TREC-scale corpora (Zipf term distribution) + topics + qrels.

The paper evaluates on TREC Disks 4&5 (528,155 docs) and ClueWeb09 (50.2M).
We synthesise corpora with matched statistics: Zipf-1.07 unigram distribution,
log-normal document lengths (mean ≈ 300 terms for Robust, ≈ 800 for web), and
topics of configurable length (T / TD / TDN ≈ 3 / 10 / 30 terms).

Relevance is *planted*: each topic selects a set of relevant documents whose
term distributions are tilted toward the topic terms (with noise), so
effectiveness metrics are non-degenerate without making any single weighting
model trivially perfect.
"""
from __future__ import annotations

import dataclasses

import numpy as np

ROBUST_DOCS = 528_155
CLUEWEB_DOCS = 50_220_423   # descriptor scale; materialised only in dry-runs


@dataclasses.dataclass
class Corpus:
    doc_terms: np.ndarray      # [total_tokens] int32 term ids, doc-major
    doc_start: np.ndarray      # [D+1] int64 CSR offsets
    vocab: int

    @property
    def n_docs(self) -> int:
        return len(self.doc_start) - 1


def synthesize_corpus(n_docs: int = 20_000, vocab: int = 50_000,
                      mean_len: int = 300, seed: int = 0,
                      zipf_s: float = 1.07) -> Corpus:
    rng = np.random.default_rng(seed)
    lens = np.maximum(
        rng.lognormal(np.log(mean_len), 0.5, n_docs).astype(np.int64), 8)
    total = int(lens.sum())
    # Zipf sampling via inverse-CDF over precomputed weights
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    w = ranks ** -zipf_s
    cdf = np.cumsum(w / w.sum())
    u = rng.random(total)
    terms = np.searchsorted(cdf, u).astype(np.int32)
    doc_start = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lens, out=doc_start[1:])
    return Corpus(terms, doc_start, vocab)


@dataclasses.dataclass
class Topics:
    qids: np.ndarray          # [NQ] int32
    terms: np.ndarray         # [NQ, MAXQ] int32, padded with -1
    weights: np.ndarray       # [NQ, MAXQ] float32 (0 where padded)
    qrels: dict[int, dict[int, int]]   # qid -> {docid: grade}


def synthesize_topics(corpus: Corpus, n_topics: int = 50, q_len: int = 3,
                      max_q_len: int = 32, rels_per_topic: int = 30,
                      seed: int = 1) -> Topics:
    """Sample mid-frequency query terms; plant graded relevant docs by
    injecting topic terms into their token streams."""
    rng = np.random.default_rng(seed)
    lo, hi = corpus.vocab // 200, corpus.vocab // 4  # mid-frequency band
    terms = np.full((n_topics, max_q_len), -1, np.int32)
    weights = np.zeros((n_topics, max_q_len), np.float32)
    qrels: dict[int, dict[int, int]] = {}
    for q in range(n_topics):
        qt = rng.choice(np.arange(lo, hi), size=q_len, replace=False).astype(np.int32)
        terms[q, :q_len] = qt
        weights[q, :q_len] = 1.0
        # relevant docs: mild, graded term injection (noisy — some rel docs
        # receive few topic terms and will be missed by lexical rankers)
        picked = rng.choice(corpus.n_docs, size=4 * rels_per_topic, replace=False)
        rel_docs, distractors = picked[:rels_per_topic], picked[rels_per_topic:]
        grades = {}
        for j, d in enumerate(rel_docs):
            grade = 2 if j < rels_per_topic // 5 else 1
            s, e = corpus.doc_start[d], corpus.doc_start[d + 1]
            n_inject = min(int(rng.poisson(1 + grade * q_len / 2)) + 1, e - s)
            pos = rng.integers(s, e, n_inject)
            corpus.doc_terms[pos] = rng.choice(qt, n_inject)
            grades[int(d)] = grade
        # distractors: topically-matching but NOT relevant documents
        for d in distractors:
            s, e = corpus.doc_start[d], corpus.doc_start[d + 1]
            n_inject = min(int(rng.poisson(0.8)) + 1, e - s)
            pos = rng.integers(s, e, n_inject)
            corpus.doc_terms[pos] = rng.choice(qt, n_inject)
        qrels[q] = grades
    return Topics(np.arange(n_topics, dtype=np.int32), terms, weights, qrels)


def expand_topics(topics: Topics, q_len: int, seed: int = 2) -> Topics:
    """Lengthen topics (T -> TD -> TDN formulations) by sampling extra terms
    correlated with the originals (hash-derived neighbours + noise)."""
    rng = np.random.default_rng(seed)
    terms = topics.terms.copy()
    weights = topics.weights.copy()
    for q in range(terms.shape[0]):
        base = terms[q][terms[q] >= 0]
        have = len(base)
        vocab_hi = int(base.max() * 2 + 7)
        extra = []
        while have + len(extra) < q_len:
            t = int(base[rng.integers(0, len(base))])
            extra.append((t * 31 + 7 + int(rng.integers(0, 64))) % vocab_hi)
        terms[q, have:have + len(extra)] = np.array(extra, np.int32)
        weights[q, have:have + len(extra)] = 0.5   # description terms weigh less
    return Topics(topics.qids, terms, weights, topics.qrels)
