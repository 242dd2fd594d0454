"""Share of the traced window spent building each call's plan: the union of
the program's ``plan.build`` spans (``ExperimentPlan.__init__``: the
compile passes and the shared-prefix trie, rebuilt on every Experiment
call) over the window."""
import spans


def read(view):
    s = spans.Spans.of(view.profile)
    t = None if s is None else s.seconds("plan.build")
    return None if t is None else t / view.profile.window_s
