"""Postings from a raw token stream: each (term, document) pair once with
its term frequency, term-major, and the collection statistics the
weighting models read.  Terms whose document frequency exceeds
``stop_df_fraction`` of the documents are stopwords and lose their
postings, as the collection's index configuration states."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Postings:
    term_start: torch.Tensor    # [V+1] int64 offsets into doc / tf
    doc: torch.Tensor           # [P] int64, ascending within a term
    tf: torch.Tensor            # [P] int64
    df: torch.Tensor            # [V] int64, 0 for stopwords
    cf: torch.Tensor            # [V] int64 collection frequency (all tokens)
    doc_len: torch.Tensor       # [D] int64 tokens per document
    n_docs: int
    vocab: int
    avg_doclen: float
    total_terms: int

    def stats(self) -> dict:
        return {"n_docs": self.n_docs, "avg_doclen": self.avg_doclen,
                "total_terms": self.total_terms}

    def term(self, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(docs, tfs) of term ``t``."""
        a, b = int(self.term_start[t]), int(self.term_start[t + 1])
        return self.doc[a:b], self.tf[a:b]

    def doc_major(self) -> "DocTerms":
        """The same pairs document-major, terms ascending within a doc."""
        order = torch.argsort(self.doc * self.vocab + self.term_ids(),
                              stable=True)
        doc = self.doc[order]
        counts = torch.bincount(doc, minlength=self.n_docs)
        start = torch.zeros(self.n_docs + 1, dtype=torch.int64,
                            device=doc.device)
        start[1:] = torch.cumsum(counts, 0)
        return DocTerms(start, self.term_ids()[order], self.tf[order])

    def term_ids(self) -> torch.Tensor:
        lens = self.term_start[1:] - self.term_start[:-1]
        return torch.repeat_interleave(
            torch.arange(self.vocab, device=lens.device), lens)


@dataclasses.dataclass
class DocTerms:
    start: torch.Tensor     # [D+1] int64
    term: torch.Tensor      # [P] int64
    tf: torch.Tensor        # [P] int64

    def of(self, d: int) -> tuple[torch.Tensor, torch.Tensor]:
        a, b = int(self.start[d]), int(self.start[d + 1])
        return self.term[a:b], self.tf[a:b]


def build_postings(tokens: torch.Tensor, doc_start: torch.Tensor, vocab: int,
                   stop_df_fraction: float) -> Postings:
    """tokens [T] term ids (document-major), doc_start [D+1] -> Postings,
    on the tokens' device."""
    dev = tokens.device
    D = int(doc_start.shape[0]) - 1
    lens = (doc_start[1:] - doc_start[:-1]).long()
    docs = torch.repeat_interleave(torch.arange(D, device=dev), lens)
    keys = tokens.long() * D + docs
    del docs
    keys = torch.sort(keys).values
    pairs, tf = torch.unique_consecutive(keys, return_counts=True)
    del keys
    term, doc = pairs // D, pairs % D
    del pairs
    df = torch.bincount(term, minlength=vocab)
    cf = torch.bincount(tokens.long(), minlength=vocab)
    stop = df > stop_df_fraction * D
    keep = ~stop[term]
    term, doc, tf = term[keep], doc[keep], tf[keep]
    df = torch.where(stop, 0, df)
    term_start = torch.zeros(vocab + 1, dtype=torch.int64, device=dev)
    term_start[1:] = torch.cumsum(df, 0)
    return Postings(term_start=term_start, doc=doc, tf=tf, df=df, cf=cf,
                    doc_len=lens, n_docs=D, vocab=vocab,
                    avg_doclen=float(lens.double().mean()),
                    total_terms=int(lens.sum()))
