"""The RAG answer stage's prompt, as the pipeline's Generate stage defines
it: the query's terms, then the distinct terms of each of the first
``prompt_docs`` ranked documents in ascending term order (stopwords left
out, as the index leaves them out), each term t mapped to the LM token
2 + t mod (vocab - 2) (0 and 1 are reserved), cut to ``max_prompt_len``
and, when shorter, repeated from its start to fill it."""
from __future__ import annotations

import torch

from reference.postings import DocTerms


def assemble(dt: DocTerms, terms, docids, *, vocab: int, max_prompt_len: int,
             prompt_docs: int) -> torch.Tensor:
    """[max_prompt_len] int64 tokens of one query (terms: its term ids,
    -1 pads; docids: its ranking)."""
    parts = [torch.as_tensor([int(t) for t in terms if t >= 0],
                             dtype=torch.int64, device=dt.term.device)]
    for d in list(docids)[:prompt_docs]:
        if int(d) >= 0:
            parts.append(dt.of(int(d))[0])
    seq = 2 + torch.cat(parts) % (vocab - 2)
    P = int(max_prompt_len)
    n = min(max(int(seq.numel()), 1), P)
    if seq.numel() == 0:
        seq = torch.zeros(1, dtype=torch.int64, device=dt.term.device)
    return seq[:n][torch.arange(P, device=seq.device) % n]
