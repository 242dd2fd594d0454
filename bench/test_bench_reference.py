"""The plain reference: the weighting models on a corpus small enough to
work out by hand, the tie rule of a ranking, stopwords, and the
reference's prompt and LM forward beside the program's at a tiny size on
the CPU."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import gen
import harness
import tinycell
from reference import lm as RL
from reference import sparse as RS
from reference.postings import build_postings
from reference.prompt import assemble

DOCS = [[1, 1, 2], [2, 3], [1, 3, 3, 3]]


def _post(stop=1.0):
    toks = torch.tensor([t for d in DOCS for t in d], dtype=torch.int32)
    start = torch.tensor([0, 3, 5, 9], dtype=torch.int64)
    return build_postings(toks, start, 5, stop)


def test_postings_and_stats():
    p = _post()
    assert p.df.tolist() == [0, 2, 2, 2, 0] and p.cf.tolist() == [0, 3, 2, 4, 0]
    assert p.avg_doclen == 3.0 and p.total_terms == 9
    d, tf = p.term(3)
    assert d.tolist() == [1, 2] and tf.tolist() == [1, 3]
    assert p.doc_major().of(2)[0].tolist() == [1, 3]
    stopped = _post(stop=0.5)       # df 2 > 1.5: every term stopped
    assert int(stopped.doc.numel()) == 0 and stopped.df.sum() == 0


def test_bm25_by_hand():
    p = _post()
    s = RS.dense_scores(p, [1], [1.0], "BM25")
    idf = math.log1p((3 - 2 + 0.5) / (2 + 0.5))
    want = [idf * 2 * 2.2 / (2 + 1.2 * (0.25 + 0.75 * 3 / 3)), 0.0,
            idf * 1 * 2.2 / (1 + 1.2 * (0.25 + 0.75 * 4 / 3))]
    assert s.tolist() == pytest.approx(want, rel=1e-6)


def test_tf_idf_and_ql_by_hand():
    p = _post()
    s = RS.dense_scores(p, [3], [1.0], "TF_IDF")
    idf = math.log(3 / 2)
    k1, k2 = 1.2 * (0.25 + 0.75 * 2 / 3), 1.2 * (0.25 + 0.75 * 4 / 3)
    assert s.tolist() == pytest.approx([0.0, idf / (1 + k1),
                                        idf * 3 / (3 + k2)], rel=1e-6)
    q = RS.dense_scores(p, [3], [1.0], "QL")
    pc = 4 / 9
    want = [0.0] + [math.log((tf + 2500 * pc) / (dl + 2500)) -
                    math.log(2500 * pc / (dl + 2500))
                    for tf, dl in ((1, 2), (3, 4))]
    assert q.tolist() == pytest.approx(want, rel=1e-5, abs=1e-6)
    f = RS.doc_features(p, [3, 1], [1.0, 1.0], torch.tensor([2, 0]), "QL")
    assert float(f[0]) == pytest.approx(
        float(q[2]) + float(RS.dense_scores(p, [1], [1.0], "QL")[2]),
        rel=1e-6)


def test_ranking_ties_go_to_the_lowest_id():
    d, s = RS.ranked(torch.tensor([1.0, 3.0, 3.0, 0.0, 3.0]), 4)
    assert d.tolist() == [1, 2, 4, 0] and s.tolist() == [3.0, 3.0, 3.0, 1.0]


@pytest.mark.parametrize("model", ["BM25", "QL", "TF_IDF"])
def test_models_beside_the_programs(model):
    """The reference's formulas and the program's, float32, at random
    postings: equal to rounding."""
    from repro_torch.index import scoring
    g = torch.Generator().manual_seed(3)
    tf = torch.randint(0, 20, (1000,), generator=g)
    dl = torch.randint(8, 900, (1000,), generator=g)
    df = torch.randint(1, 5000, (1000,), generator=g)
    cf = df * 3
    stats = {"n_docs": 528155, "avg_doclen": 339.7, "total_terms": 179_000_000}
    ours = RS.model_scores(model, tf, dl, df, cf, stats)
    theirs = scoring.WEIGHTING_MODELS[model](tf, dl, df, cf, stats)
    torch.testing.assert_close(ours, theirs, rtol=1e-6, atol=1e-6)


def test_prompt_and_lm_beside_the_programs():
    """At a tiny size on the CPU: the reference's prompt equals the
    program's, and its float32 logits the program's prefill's."""
    import repro_torch as rt
    from repro_torch.core.stages import assemble_prompt_fn
    from repro_torch.models import transformer_lm as tlm
    cell = tinycell.tiny("rag-qwen2.t250")
    data, _ = harness.build_data(cell, 21, "cpu", rt)
    st = harness.reference_state(cell, data, "cpu")
    terms = np.array([[30, 41, 57] + [-1] * 45], np.int32)
    docids = torch.tensor([[5, 17, 2999, 8]], dtype=torch.int32)
    ours = assemble(st.doc_terms, terms[0].tolist(), docids[0].tolist(),
                    vocab=512, max_prompt_len=64, prompt_docs=4)
    theirs = assemble_prompt_fn(data.index, vocab=512, max_prompt_len=64,
                                prompt_docs=4)(
        torch.as_tensor(terms), torch.ones(1, 48), docids)[0]
    assert ours.tolist() == theirs.long().tolist()
    w = gen.lm_weights(tinycell.LM, 4, "cpu")
    cfg, lm = harness.program_lm(rt, tinycell.LM, w, "cpu")
    cache = tlm.init_kv_cache(cfg, 1, 64, device="cpu")
    logits, _ = tlm.prefill(cfg, lm, ours[None].to(torch.int32), cache)
    ref = RL.forward_logits(tinycell.LM, w, ours[None], 63)[:, 0]
    torch.testing.assert_close(ref, logits.float(), rtol=1e-4, atol=1e-4)


def test_fp8_control_rounds_coarser():
    x = torch.linspace(-3, 3, 1001)
    e = (RL.fp8(x) - x).abs().max()
    assert 1e-3 < float(e) < 0.2
