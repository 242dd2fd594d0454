"""The card's constants for the roofline terms of the dry runs (the port of
``src/repro/launch/mesh.py``'s constants, which are a TPU v5e's).

One card has no mesh: ``make_production_mesh`` and ``make_query_mesh``
(the reference's 16x16 and 2x16x16 meshes, the serving engine's query
mesh) wait for the multi-card slice, and ``make_host_mesh``'s 1x1 mesh is
the one card itself.  Each figure below is quoted for the card the port
is measured on, ``NVIDIA H100 80GB HBM3, 700.00 W`` (the H100 SXM
datasheet); :func:`memory_bytes` reads the card's memory at run time when
one is present.
"""
from __future__ import annotations

import torch

#: the card the figures below are quoted for (nvidia-smi's name and power
#: limit)
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: dense bf16 on the tensor cores, FLOP/s (H100 SXM datasheet)
PEAK_FLOPS_BF16 = 989e12
#: fp32 outside the tensor cores, FLOP/s (H100 SXM datasheet)
PEAK_FLOPS_FP32 = 67e12
#: HBM3 bandwidth, B/s (H100 SXM datasheet)
HBM_BW = 3.35e12
#: HBM3 capacity, bytes (H100 SXM datasheet: 80 GB)
HBM_BYTES = 80e9


def memory_bytes() -> float:
    """The memory of the card in use (``total_memory`` of CUDA device 0),
    or the datasheet's ``HBM_BYTES`` without a card."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return HBM_BYTES


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak rate for a step whose arithmetic is in ``dtype``:
    the bf16 tensor cores for bf16 and fp16, else fp32 on the CUDA
    cores."""
    return PEAK_FLOPS_BF16 if dtype in (torch.bfloat16, torch.float16) \
        else PEAK_FLOPS_FP32
