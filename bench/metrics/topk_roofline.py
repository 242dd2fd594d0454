"""The top-k kernel's share of its roofline, in percent: the least time of
the window's calls (every score read once, k pairs a row written, at the
HBM rate) over the device time of ``topk_segments_kernel`` and
``topk_merge_kernel`` in the window."""
import roofline

KERNELS = ("topk_segments_kernel", "topk_merge_kernel")


def read(view):
    if view.profile is None or view.recorder is None:
        return None
    calls = [s for w, s in view.recorder.calls["topk"] if w]
    n, t = view.profile.kernels(*KERNELS)
    if not calls or not n or t <= 0:
        return None
    least = sum(roofline.least_time(*roofline.topk_cost(*c),
                                    roofline.FP32_FLOPS) for c in calls)
    return 100.0 * least / t
