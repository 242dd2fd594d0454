"""The yardstick's formulas on shapes worked out by hand."""
from __future__ import annotations

import pytest

import roofline
import sparse_work
import pipeline as PL


def test_topk_on_the_rq1_chunk():
    flops, nbytes = roofline.topk_cost(16, 528155, 10)
    assert nbytes == 16 * 528155 * 4 + 16 * 10 * 8
    t = roofline.least_time(flops, nbytes, roofline.FP32_FLOPS)
    assert t == pytest.approx(nbytes / 3.35e12)
    assert t * 1e3 == pytest.approx(0.0101, abs=1e-4)


def test_fused_scoring_on_the_rq2_chunk():
    n = 16 * 48 * 52608
    flops, nbytes = roofline.fused_scoring_cost(n, 16 * 48,
                                                ("BM25", "QL", "TF_IDF"))
    assert flops == n * 32
    assert nbytes == n * 8 + 16 * 48 * 8 + n * 3 * 4
    assert roofline.least_time(flops, nbytes, roofline.FP32_FLOPS) == \
        pytest.approx(nbytes / 3.35e12)


def test_visible_pairs():
    assert roofline.visible_pairs(4, 4) == 10
    assert roofline.visible_pairs(4, 4, causal=False) == 16
    assert roofline.visible_pairs(4, 4, chunk=2) == 6
    assert roofline.visible_pairs(1024, 1024) == 1024 * 1025 // 2


def test_flash_on_the_rag_prefill():
    flops, nbytes = roofline.flash_cost(16, 1024, 1024, 12, 2, 128, 2)
    assert flops == 4.0 * 16 * 12 * 128 * (1024 * 1025 // 2)
    assert nbytes == (2 * 16 * 1024 * 12 * 128 + 2 * 16 * 1024 * 2 * 128) * 2
    t = roofline.least_time(flops, nbytes, roofline.BF16_FLOPS)
    assert t == pytest.approx(flops / 989e12)       # compute-bound
    assert t * 1e3 == pytest.approx(0.0522, abs=1e-3)


def test_lm_flops_counted_by_hand():
    lm = {"n_layers": 2, "d_model": 8, "n_q": 2, "n_kv": 1, "d_head": 4,
          "d_ff": 16, "vocab": 10}
    layer = 8 * 4 * (2 * 2 + 2 * 1) + 3 * 8 * 16
    assert roofline.lm_layer_params(lm) == layer
    body, head, attn = 2 * 2 * layer, 2 * 8 * 10, 4 * 2 * 2 * 4
    want = 5 * body + head + attn * 15          # prefill of 5 tokens
    want += 2 * (body + head) + attn * (6 + 7)  # two decode steps
    assert roofline.lm_sequence_flops(lm, 5, 3) == want


def test_sparse_work_of_a_call():
    class View:
        work = {"df": __import__("numpy").array([0, 10, 20, 30, 40])}

        class cell:
            config = {"index": {"default_k": 100}}
    tree = PL.parse("(Retrieve('BM25') >> (Extract('QL') ** "
                    "Extract('TF_IDF'))) % 50")
    terms = [[1, 2, -1], [2, 3, -1]]           # distinct: 1, 2, 3
    t = sparse_work.least_time(View, tree, terms)
    postings = 10 + 20 + 30
    nbytes = postings * 8 + 2 * 50 * (8 + 4 * 2)
    ops = postings * 12 + 2 * 100 * 2 * (12 + 8)
    assert t == pytest.approx(max(nbytes / 3.35e12, ops / 67e12))
