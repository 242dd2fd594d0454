"""The generators: equal seeds give equal inputs, other seeds other ones,
and calls drawn together judge each topic as one drawn alone."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import gen
import tinycell
from reference.postings import build_postings

SEEDS = (0, 7, 2 ** 31 + 11, 3_000_000_123)


def _collection(seed):
    return gen.draw_collection(tinycell.COLLECTION, seed, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_collection_repeats_for_a_seed(seed):
    a, b = _collection(seed), _collection(seed)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = _collection(seed + 1)
    assert not torch.equal(a[1], c[1])
    lens = a[1][1:] - a[1][:-1]
    assert int(lens.min()) >= tinycell.COLLECTION["min_len"]
    assert int(a[0].max()) < tinycell.COLLECTION["vocab"]


def test_topics_and_judgements_repeat():
    tokens, start = _collection(5)
    post = build_postings(tokens, start, 4000, 0.1)
    tr = {"band": [0.005, 0.25], "terms_per_topic": 3}
    a = gen.TopicStream(post, tr, 5, "topics").draw(30)
    b = gen.TopicStream(post, tr, 5, "topics").draw(30)
    assert np.array_equal(a["terms"], b["terms"]) and a["qrels"] == b["qrels"]
    assert all(len(set(r)) == 3 for r in a["terms"].tolist())
    assert a["terms"].min() >= 20 and a["terms"].max() < 1000
    # judgements: docs holding >= 2 of the topic's terms, grade held - 1
    q, t = int(a["qid"][0]), a["terms"][0]
    held = {}
    for term in t:
        for d in post.term(int(term))[0].tolist():
            held[d] = held.get(d, 0) + 1
    assert a["qrels"][q] == {d: n - 1 for d, n in held.items() if n >= 2}


@pytest.mark.parametrize("seed", SEEDS)
def test_calls_drawn_together_judge_each_topic(seed):
    """Calls drawn in one block: each its own qids and terms, judged as a
    loop over each topic's postings judges it."""
    tokens, start = _collection(seed)
    post = build_postings(tokens, start, 4000, 0.1)
    tr = {"band": [0.005, 0.25], "terms_per_topic": 3}
    calls = gen.TopicStream(post, tr, seed, "topics").draw_calls(4, 25)
    assert len(calls) == 4
    assert np.array_equal(np.concatenate([c["qid"] for c in calls]),
                          np.arange(100))
    for c in calls:
        assert c["terms"].shape == c["weights"].shape == (25, 3)
        assert set(c["qrels"]) == set(c["qid"].tolist())
        for q, t in zip(c["qid"].tolist(), c["terms"]):
            held = {}
            for term in t:
                for d in post.term(int(term))[0].tolist():
                    held[d] = held.get(d, 0) + 1
            assert c["qrels"][q] == {d: n - 1 for d, n in held.items()
                                     if n >= 2}


def test_calls_to_draw_cover_the_window_twice():
    import harness
    # 20 s at 0.1 s a call of 250: 200 calls the window holds
    n = harness.calls_to_draw(20.0, 0.1 / 250, 250)
    assert n % harness.DRAW_BLOCK == 0 and 402 <= n < 402 + harness.DRAW_BLOCK
    assert harness.calls_to_draw(20.0, 6.0 / 250, 250) == harness.DRAW_BLOCK


def test_lm_weights_repeat_and_scale():
    a = gen.lm_weights(tinycell.LM, 9, "cpu")
    b = gen.lm_weights(tinycell.LM, 9, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["layers"][1]["w_down"], b["layers"][1]["w_down"])
    assert abs(float(a["embed"].std()) - gen.EMBED_STD) < 0.002
    wq = a["layers"][0]["wq"]
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.02
    c = gen.lm_weights(tinycell.LM, 10, "cpu")
    assert not torch.equal(a["embed"], c["embed"])


def test_sub_seeds_differ_by_tag_and_fit_63_bits():
    s = {gen.sub_seed(2 ** 40 + 3, t) for t in ("a", "b", "c")}
    assert len(s) == 3 and all(0 <= x < 2 ** 63 for x in s)
