"""The flash-attention kernel's share of its roofline, in percent: each
launch in the window priced at the shape of the calls the program made
(causal operations at the bf16 tensor-core peak, or q, k, v and the output
at the HBM rate, whichever is larger) over the device time of the
``flash_attention_kernel`` launches.  The launches run inside captured
CUDA graphs, so the shape comes from the calls made while they were
captured: the reading stands only where all calls had one shape."""
import roofline

KERNELS = ("flash_attention_kernel",)


def read(view):
    if view.profile is None or view.recorder is None:
        return None
    shapes = {s for _, s in view.recorder.calls["flash"]}
    n, t = view.profile.kernels(*KERNELS)
    if len(shapes) != 1 or not n or t <= 0:
        return None
    B, S, T, H, Hkv, D, elem, causal, chunk = shapes.pop()
    flops, nbytes = roofline.flash_cost(B, S, T, H, Hkv, D, elem, causal,
                                        chunk)
    peak = roofline.BF16_FLOPS if elem == 2 else roofline.FP32_FLOPS
    return 100.0 * n * roofline.least_time(flops, nbytes, peak) / t
