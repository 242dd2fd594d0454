"""Hand-written CUDA kernels for Hopper, each beside its plain version.

Each kernel's launches are counted twice.  Its wrapper adds one to its
``.launches`` where it launches the kernel from the host: an eager launch,
or one recorded into a CUDA graph that is being captured.  And the kernel
itself adds one to a counter in device memory each time it runs
(``csrc/launch_count.cuh``), so a launch replayed inside a captured graph,
where no host code runs, is counted too: :func:`device_launches` reads
those counts.
"""

#: kernel -> the device counters of the sources its wrapper launches from
DEVICE_COUNTERS = {
    "topk": ("repro_launches_topk",),
    "fused_scoring": ("repro_launches_fused_scoring",),
    "dense_topk": ("repro_launches_dense_topk",),
    "pq_topk": ("repro_launches_pq_topk",),
    # fp32 (csrc/flash_attention.cu) and bf16 (csrc/flash_attention_sm90.cu)
    "flash_attention": ("repro_launches_flash_attention",
                        "repro_launches_flash_attention_sm90"),
}


def wrappers() -> dict:
    """The kernels' wrappers by kernel name, each counting the host
    launches of its kernel in ``.launches``."""
    from repro_torch.kernels.dense_scoring.ops import streaming_dense_topk
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_scoring.ops import fused_scoring
    from repro_torch.kernels.pq_scoring.ops import streaming_pq_topk
    from repro_torch.kernels.topk.ops import streaming_topk
    return {"topk": streaming_topk, "fused_scoring": fused_scoring,
            "dense_topk": streaming_dense_topk, "pq_topk": streaming_pq_topk,
            "flash_attention": flash_attention}


def device_launches(device=None, *, reset: bool = False) -> dict[str, int]:
    """Runs of each kernel counted by the kernel itself since the last
    reset, on the CUDA ``device`` given, or summed over every card present
    when ``device`` is None (``reset=True`` sets the counts read to 0
    after reading them).  Each card keeps its own counts, read under that
    card.  Builds the kernels if they are not built; call it between runs,
    after a synchronise, never while a stream is being captured."""
    import ctypes

    import torch

    from repro_torch.kernels import _build
    lib = _build.library()
    cards = ([torch.device(device)] if device is not None else
             [torch.device("cuda", i)
              for i in range(torch.cuda.device_count())])
    out = {name: 0 for name in DEVICE_COUNTERS}
    for card in cards:
        with torch.cuda.device(card):
            for name, readers in DEVICE_COUNTERS.items():
                for reader in readers:
                    count = ctypes.c_uint(0)
                    _build.check(getattr(lib, reader)(
                        ctypes.addressof(count), int(reset)), reader)
                    out[name] += count.value
    return out
