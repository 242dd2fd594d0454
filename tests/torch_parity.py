"""Shared inputs and comparisons for the tests that hold the PyTorch port
(``repro_torch``) against the JAX package (``repro``).

Both sides get the same inputs, made from a seed with numpy and passed
across as numpy arrays.  The reference backend is sequential
(``sharded=False``): the sharded engine does not run under every jax
version this suite meets.
"""
import numpy as np

from repro.index.corpus import synthesize_corpus, synthesize_topics

RTOL, ATOL = 2e-5, 1e-5


def small_env():
    """The tests/conftest.py corpus (3000 docs, vocab 12000, seeds 7/8)
    with its T topics and a TD expansion."""
    from repro.index.corpus import expand_topics
    corpus = synthesize_corpus(n_docs=3000, vocab=12000, mean_len=100, seed=7)
    topics = synthesize_topics(corpus, n_topics=8, q_len=3, rels_per_topic=12,
                               seed=8)
    topics_td = expand_topics(topics, q_len=10, seed=9)
    return corpus, topics, topics_td


def jax_queries(topics):
    from repro.core.data import make_queries
    return make_queries(np.asarray(topics.terms), np.asarray(topics.weights),
                        np.asarray(topics.qids))


def torch_queries(topics):
    from repro_torch.core.data import make_queries
    return make_queries(topics.terms, topics.weights, topics.qids,
                        device="cpu")


def assert_ranking_parity(ref_docs, ref_scores, docs, scores, *, what=""):
    """Scores agree at rtol 2e-5 / atol 1e-5, and docids are equal except
    at ranks where the reference's neighbouring scores lie within that
    tolerance of each other (a tie whose order rounding may flip), or at
    the last rank, whose neighbour lies past the cut.
    Returns the list of such ties, which the caller reports."""
    ref_docs, docs = np.asarray(ref_docs), np.asarray(docs)
    ref_scores, scores = np.asarray(ref_scores), np.asarray(scores)
    assert ref_docs.shape == docs.shape, (what, ref_docs.shape, docs.shape)
    np.testing.assert_allclose(scores, ref_scores, rtol=RTOL, atol=ATOL,
                               err_msg=what)
    ties = []
    for q, r in zip(*np.nonzero(ref_docs != docs)):
        row = ref_scores[q]
        tol = ATOL + RTOL * abs(row[r])
        # at the last rank the neighbour lies past the cut: there the port's
        # own score, within tolerance of the reference's, stands for it
        near = [j for j in (r - 1, r + 1) if 0 <= j < row.shape[0]
                and abs(row[j] - row[r]) <= tol] + \
            ([r] if r == row.shape[0] - 1 else [])
        assert near, (f"{what}: query {q} rank {r}: reference doc "
                      f"{ref_docs[q, r]} ({row[r]!r}), port doc {docs[q, r]} "
                      f"({scores[q, r]!r}) with no tied neighbour")
        ties.append((int(q), int(r), float(row[r])))
    if ties:
        print(f"{what}: {len(ties)} rank(s) differ inside a score tie: "
              f"{ties[:10]}")
    return ties
