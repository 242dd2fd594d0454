"""Plain dense re-scoring: a document's embedding is the random projection
of its terms (numpy's standard normal draws from the configuration's
projection seed, [vocab, dim] / sqrt(dim)), each scaled by log1p(tf) and
summed, then normalised; a query's is the weighted sum of its terms' rows,
normalised.  A candidate's dense score is alpha x its sparse score plus
the dot product of the two embeddings."""
from __future__ import annotations

import numpy as np
import torch

from reference.postings import DocTerms


def projection(vocab: int, dim: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((vocab, dim)).astype(np.float32) / np.sqrt(dim)
    return torch.as_tensor(proj.astype(np.float32), device=device)


def doc_embeddings(dt: DocTerms, proj: torch.Tensor, docids: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """[n, dim] unit embeddings of ``docids`` (1-d, on proj's device)."""
    d = docids.long()
    start, stop = dt.start[d], dt.start[d + 1]
    lens = stop - start
    owner = torch.repeat_interleave(torch.arange(d.numel(), device=d.device),
                                    lens)
    offs = torch.arange(int(lens.sum()), device=d.device) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    at = torch.repeat_interleave(start, lens) + offs
    rows = proj[dt.term[at]].to(dtype) * torch.log1p(dt.tf[at].to(dtype))[:, None]
    emb = torch.zeros((d.numel(), proj.shape[1]), dtype=dtype, device=d.device)
    emb.index_add_(0, owner, rows)
    return emb / torch.linalg.norm(emb, dim=1, keepdim=True).clamp(min=1e-6)


def query_embedding(proj: torch.Tensor, terms, weights,
                    dtype=torch.float32) -> torch.Tensor:
    vec = torch.zeros(proj.shape[1], dtype=dtype, device=proj.device)
    for t, w in zip(terms, weights):
        if t >= 0:
            vec += proj[int(t)].to(dtype) * float(w)
    return vec / torch.linalg.norm(vec).clamp(min=1e-6)
