"""Share of the traced window the host spends evaluating results: the union
of the program's ``experiment.measures`` spans (``compute_measures`` of
each pipeline's row, after the call's device work has finished) over the
window."""
import spans


def read(view):
    s = spans.Spans.of(view.profile)
    t = None if s is None else s.seconds("experiment.measures")
    return None if t is None else t / view.profile.window_s
