"""How ``correct`` is decided: the outputs the timed path produced for a
sample of its queries, held against the plain reference (``reference/``)
at the cell's sizes.  Each number is a widest gap:

* ``score_gap``: the final scores, rank by rank against the reference's
  ranking, and each returned document's score against the reference's
  score of that document (a wrong document shows here), relative to the
  query's top reference score;
* ``feature_gap``: each returned document's feature columns against the
  reference's, relative to the query's largest reference value of that
  feature;
* ``logit_gap``: for a served LM answer, how far each generated token's
  logit lies below the reference's best logit at its position (logit
  units), the reference run over the prompt and the served tokens.

The control is the reference itself in the precision below the
configuration's (``dtype`` / ``lowp``) put in the program's place."""
from __future__ import annotations

import math

import torch

from reference import dense as RD
from reference import sparse as RS
from reference.evaluate import RefState, evaluate
from reference.lm import forward_logits
from reference.prompt import assemble


def score_of(node, st: RefState, terms, weights, docids):
    """The reference's final score of each of ``docids`` under ``node``:
    the last scoring stage's (a Retrieve's model score; a DenseRerank's
    alpha x the score before it + the dot product), None for a tree that
    scores nothing."""
    if node.op == "then":
        a, b = node.children
        sa = score_of(a, st, terms, weights, docids)
        while b.op == "cutoff":
            b = b.children[0]
        if b.op == "stage" and b.name == "DenseRerank":
            alpha = float(b.param(0, "alpha", 0.0))
            emb = RD.doc_embeddings(st.doc_terms, st.proj,
                                    docids.clamp(min=0), st.dtype)
            qv = RD.query_embedding(st.proj, terms, weights, st.dtype)
            return alpha * sa.to(st.dtype) + emb @ qv
        sb = score_of(b, st, terms, weights, docids)
        return sa if sb is None else sb
    if node.op in ("cutoff", "union"):
        return score_of(node.children[0], st, terms, weights, docids)
    if node.name == "Retrieve":
        s = RS.dense_scores(st.post, terms, weights,
                            node.param(0, "model", "BM25"), st.dtype)
        return s[docids.clamp(min=0)]
    return None


def compare_query(node, st: RefState, terms, weights, out: dict) -> dict:
    """Gaps of one query's program outputs ``out`` (docids [K], scores
    [K], features [K, F] or None, on the reference's device)."""
    ref = evaluate(node, st, terms, weights)
    d, s = out["docids"].long(), out["scores"].float()
    K = d.shape[0]
    rs = ref["scores"][:K].float()
    scale = float(rs.abs().max()) if rs.numel() else 1.0
    gaps = {"score_gap": max(RS.relative_gap(s, rs, scale),
                             RS.relative_gap(s, score_of(
                                 node, st, terms, weights, d).float(),
                                 scale))}
    if out.get("features") is not None:
        f = out["features"].float()
        fr = torch.stack([RS.doc_features(st.post, terms, weights, d, m,
                                          st.dtype).float()
                          for m in _feature_models(node)], -1)
        g = 0.0
        for j in range(f.shape[-1]):
            g = max(g, RS.relative_gap(f[:, j], fr[:, j],
                                       float(fr[:, j].abs().max())))
        gaps["feature_gap"] = g
    return gaps


def _feature_models(node) -> list[str]:
    return [n.param(0, "model") for n in node.walk()
            if n.op == "stage" and n.name == "Extract"]


def logit_gaps(lmcfg: dict, weights: dict, prompts: torch.Tensor,
               tokens: torch.Tensor, block: int = 4,
               lowp: bool = False) -> torch.Tensor:
    """([n, T] gap of each position's chosen token below the reference's
    best logit, [n, T] the reference's margin of its best over its second):
    the served tokens' gaps (``lowp`` False), or those of the tokens the
    float8 control puts first (``lowp`` True); prompts [n, P], tokens
    [n, T] (served)."""
    P, T = prompts.shape[1], tokens.shape[1]
    out, margins = [], []
    for i in range(0, prompts.shape[0], block):
        seq = torch.cat([prompts[i:i + block], tokens[i:i + block, :T - 1]], 1)
        ref = forward_logits(lmcfg, weights, seq, P - 1)
        top2 = ref.topk(2, dim=-1).values
        margins.append(top2[..., 0] - top2[..., 1])
        best = top2[..., 0]
        if lowp:
            pick = forward_logits(lmcfg, weights, seq, P - 1,
                                  lowp=True).argmax(-1)
        else:
            pick = tokens[i:i + block].long()
        out.append(best - ref.gather(-1, pick[..., None])[..., 0])
        del ref
    return torch.cat(out, 0), torch.cat(margins, 0)


def prompts_for(node, st: RefState, lmcfg: dict, rows) -> torch.Tensor:
    """The reference's prompts [n, P] of the sampled queries, assembled
    from the documents the program ranked."""
    g = node.stages("Generate")[0]
    P = int(g.param(2, "max_prompt_len", 64))
    docs = int(g.param(3, "prompt_docs", 4))
    return torch.stack([assemble(st.doc_terms, r["terms"], r["docids"],
                                 vocab=lmcfg["vocab"], max_prompt_len=P,
                                 prompt_docs=docs) for r in rows])


def worst(per_query: list[dict]) -> dict:
    out: dict = {}
    for g in per_query:
        for k, v in g.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a missing limit, or a number that is
    not finite, fails)."""
    return all(k in limits and math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items())
