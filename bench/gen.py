"""Inputs of a run, all drawn from ``--seed``: the collection (document
lengths log-normal, terms Zipf-ranked, drawn on the device in a few
large calls), topics and their relevance judgements, and the LM's
weights.  Each purpose draws from a stream of its own, so
one seed always gives the same inputs."""
from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from reference.postings import Postings

#: the embedding's scale: Qwen2's config.json initializer_range
EMBED_STD = 0.02


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    state = np.random.SeedSequence(
        [int(seed) % 2 ** 64, zlib.crc32(tag.encode())]).generate_state(2)
    return (int(state[0]) << 31 | int(state[1]) >> 1) & (2 ** 63 - 1)


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))


def torch_gen(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def draw_collection(col: dict, seed: int, device):
    """(tokens [T] int32, doc_start [D+1] int64) on ``device``: document
    lengths max(floor(LogNormal(log mean_len, len_sigma)), min_len), each
    token's term the Zipf(zipf_s) rank of a uniform draw over ``vocab``
    ranks (term 0 the most frequent)."""
    g = torch_gen(seed, "collection", device)
    D, V = int(col["n_docs"]), int(col["vocab"])
    z = torch.randn(D, generator=g, device=device, dtype=torch.float64)
    lens = torch.exp(math.log(col["mean_len"]) + col["len_sigma"] * z)
    lens = lens.long().clamp(min=int(col["min_len"]))
    doc_start = torch.zeros(D + 1, dtype=torch.int64, device=device)
    doc_start[1:] = torch.cumsum(lens, 0)
    T = int(doc_start[-1])
    w = torch.arange(1, V + 1, dtype=torch.float64, device=device) \
        ** -float(col["zipf_s"])
    cdf = torch.cumsum(w / w.sum(), 0)
    u = torch.rand(T, generator=g, device=device, dtype=torch.float64)
    tokens = torch.searchsorted(cdf, u).clamp(max=V - 1).to(torch.int32)
    return tokens, doc_start


class TopicStream:
    """Topics in calls: each topic ``terms_per_topic`` distinct terms drawn
    uniformly from the band of ranks [band[0] * vocab, band[1] * vocab)
    (mid-frequency, as the collection's topics take them), weight 1.
    Judgements follow from term overlap: a document holding at least two
    of a topic's terms is relevant, with grade (terms it holds) - 1."""

    def __init__(self, post: Postings, traffic: dict, seed: int, tag: str):
        self.post = post
        self.rng = rng(seed, tag)
        V = post.vocab
        self.lo = int(traffic["band"][0] * V)
        self.hi = int(traffic["band"][1] * V)
        self.n_terms = int(traffic["terms_per_topic"])
        self.next_qid = 0

    def terms(self, n: int) -> np.ndarray:
        """[n, terms_per_topic] int32 distinct terms a row."""
        out = self.rng.integers(self.lo, self.hi, (n, self.n_terms))
        for i in range(n):
            while len(set(out[i].tolist())) < self.n_terms:
                out[i] = self.rng.integers(self.lo, self.hi, self.n_terms)
        return out.astype(np.int32)

    def draw(self, n: int) -> dict:
        """n topics: {"qid" [n] int32, "terms" [n, L] int32, "weights"
        [n, L] float32, "qrels" {qid: {doc: grade}}}."""
        return self.draw_calls(1, n)[0]

    def draw_calls(self, calls: int, n: int) -> list[dict]:
        """``calls`` sets of n topics each, as :meth:`draw` gives one, their
        terms drawn together and judged in one pass on the device."""
        terms = self.terms(calls * n)
        qids = np.arange(self.next_qid, self.next_qid + calls * n,
                         dtype=np.int32)
        self.next_qid += calls * n
        qrels = judgements(self.post, terms, qids)
        out = []
        for c in range(calls):
            sl = slice(c * n, (c + 1) * n)
            out.append({"qid": qids[sl], "terms": terms[sl],
                        "weights": np.ones(terms[sl].shape, np.float32),
                        "qrels": {int(q): qrels[int(q)] for q in qids[sl]}})
        return out


def judgements(post: Postings, terms: np.ndarray, qids: np.ndarray) -> dict:
    """{qid: {doc: grade}}: grade (query terms the doc holds) - 1, for docs
    holding at least two, docs in ascending order."""
    dev = post.doc.device
    t = torch.as_tensor(terms.reshape(-1), dtype=torch.int64, device=dev)
    start, stop = post.term_start[t], post.term_start[t + 1]
    lens = stop - start
    topic = torch.repeat_interleave(
        torch.arange(terms.shape[0], device=dev).repeat_interleave(
            terms.shape[1]), lens)
    offs = torch.arange(int(lens.sum()), device=dev) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    docs = post.doc[torch.repeat_interleave(start, lens) + offs]
    keys, counts = torch.unique(topic * post.n_docs + docs, return_counts=True)
    keep = counts >= 2
    keys, grades = keys[keep].cpu().numpy(), (counts[keep] - 1).cpu().numpy()
    top, doc = keys // post.n_docs, keys % post.n_docs
    cut = np.searchsorted(top, np.arange(terms.shape[0] + 1)).tolist()
    doc, grades = doc.tolist(), grades.tolist()
    return {int(q): dict(zip(doc[a:b], grades[a:b]))
            for q, a, b in zip(qids.tolist(), cut[:-1], cut[1:])}


def lm_weights(lm: dict, seed: int, device) -> dict:
    """The LM's weights in its serving dtype, drawn in one call: a normal
    draw of every element, scaled per leaf (embedding 0.02, the published
    config's initializer range; projections and MLP 1 / sqrt(fan-in); QKV
    biases 0.5; norm gains 1 + 0.1 N(0, 1)).  With the tied embedding this
    small the layers, not a copy of the input token, set the logits, so an
    answer is not one token repeated."""
    d, nq, nkv, dh, f, V = (lm[k] for k in ("d_model", "n_q", "n_kv",
                                            "d_head", "d_ff", "vocab"))
    dtype = getattr(torch, lm["dtype"])
    layer = [("wq", (d, nq, dh), d ** -0.5), ("wk", (d, nkv, dh), d ** -0.5),
             ("wv", (d, nkv, dh), d ** -0.5), ("wo", (nq, dh, d),
                                               (nq * dh) ** -0.5),
             ("w_gate", (d, f), d ** -0.5), ("w_up", (d, f), d ** -0.5),
             ("w_down", (f, d), f ** -0.5)]
    if lm["qkv_bias"]:
        layer += [("bq", (nq, dh), 0.5), ("bk", (nkv, dh), 0.5),
                  ("bv", (nkv, dh), 0.5)]
    per = sum(math.prod(s) for _, s, _ in layer)
    total = V * d + lm["n_layers"] * per
    g = torch_gen(seed, "lm", device)
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    gains = 1.0 + 0.1 * torch.randn((2 * lm["n_layers"] + 1, d), generator=g,
                                    device=device, dtype=torch.float32)
    at = 0

    def take(shape, scale):
        nonlocal at
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        return t.mul_(scale)

    w = {"embed": take((V, d), EMBED_STD), "layers": []}
    for i in range(lm["n_layers"]):
        p = {name: take(shape, scale) for name, shape, scale in layer}
        p["ln_attn"], p["ln_mlp"] = gains[2 * i], gains[2 * i + 1]
        w["layers"].append(p)
    w["ln_final"] = gains[-1]
    return w
