"""The fused-scoring kernel's share of its roofline, in percent: the least
time of the window's calls (each call's postings as handed to the kernel,
inputs read once and scores written once, at the HBM rate; or its
operations at the fp32 peak, whichever is larger) over the device time of
``fused_scoring_kernel`` in the window."""
import roofline

KERNELS = ("fused_scoring_kernel",)


def read(view):
    if view.profile is None or view.recorder is None:
        return None
    calls = [s for w, s in view.recorder.calls["fused_scoring"] if w]
    n, t = view.profile.kernels(*KERNELS)
    if not calls or not n or t <= 0:
        return None
    least = sum(roofline.least_time(*roofline.fused_scoring_cost(*c),
                                    roofline.FP32_FLOPS) for c in calls)
    return 100.0 * least / t
