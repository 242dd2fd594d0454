"""The LM's share of the card's bf16 peak over its own device time:
``lm.mfu`` (the model flops of every query's answer over window x 989
TFLOP/s) rescaled from the window to the device seconds of the operations
launched under the program's ``generate.lm`` spans (the replays of the
captured prefill-and-decode graphs, joined to their ``cudaGraphLaunch`` by
correlation id)."""
import harness
import spans


def read(view):
    s = spans.Spans.of(view.profile)
    t = None if s is None else s.device_seconds_under("generate.lm")
    mfu = harness.load_reader("lm.mfu")(view) if t else None
    return None if mfu is None else mfu * view.window_s / t
