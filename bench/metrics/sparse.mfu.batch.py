"""The whole retrieval step's share of the card's peak: the least time of
the window's retrieval work over the window.  A call's work: each distinct
query term's postings (doc id and tf, 8 bytes each) read once, the
results written once (doc id and score, 4 bytes each, and 4 a feature),
its first-stage model's operations a posting and each feature model's a
(result, query term) pair; the least time is the larger of bytes at the
HBM rate and operations at the fp32 peak, whatever implements it."""
import sparse_work


def read(view):
    calls = view.work.get("topics")
    if not calls or view.window_s <= 0:
        return None
    least = sum(sparse_work.least_time(view, view.trees[""], terms)
                for terms in calls)
    return least / view.window_s
