"""Meshes of cards and the card's constants for the roofline terms of the
dry runs (the port of ``src/repro/launch/mesh.py``, whose constants are a
TPU v5e's).

A :class:`Mesh` has the reference's axis names (``"data"``, ``"model"``,
and ``"pod"`` on the multi-pod shape), each axis's size, and the
coordinates of this rank on it.  :func:`make_card_mesh` builds one over
the process group (a ``DeviceMesh`` on ``"cuda"`` with NCCL, or on
``"cpu"`` with gloo, as the tests run it), with a process group for every
set of its axes, through which ``repro_torch/collectives.py`` moves
shards.  :func:`make_production_mesh` (the reference's 16x16 and 2x16x16)
and :func:`make_host_mesh` (1x1) are shape-only: they have no group, sit
at rank 0's coordinates (or those given), and serve the dry run, whose
tensors lie on ``meta``.  :func:`make_query_mesh` is the serving
engine's: the ``("data",)`` or ``("data", "docs")`` mesh over the local
cards, driven by one process (no group), its ``devices`` laid out
row-major as ``jax.make_mesh`` lays out its list.

Each figure below is quoted for the card the port is measured on,
``NVIDIA H100 80GB HBM3, 700.00 W`` (the H100 SXM datasheet and the
card's NVLink); :func:`memory_bytes` reads the card's memory at run time
when one is present.
"""
from __future__ import annotations

import itertools
import math

import torch

from repro_torch.common import resolve_device

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
#: NVLink between the cards of one host, B/s each way per card (900 GB/s
#: all to all: 450 GB/s each way); the dry run's collective term
NVLINK_BW = 450e9


class Mesh:
    """Named mesh axes (``axis_names``, major first), their sizes
    (``shape``, a name -> size mapping, as the reference's meshes have
    it), and this rank's place on them (``coords``: name -> index).  A
    live mesh also holds ``device`` (this rank's card, or the CPU) and a
    process group for every set of its axes; a shape-only one holds none
    and stands for the mesh in a dry run.  A query mesh
    (:func:`make_query_mesh`) holds ``devices``, every card of the mesh in
    an array of its shape, and ``device``, its first (the home card); one
    process drives them all, so it has no group."""

    def __init__(self, shape, axis_names, *, coords=None, groups=None,
                 device=None, devices=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = dict(coords or {a: 0 for a in self.axis_names})
        self.size = math.prod(self.shape.values())
        self.device = device
        self.devices = devices
        self._groups = groups

    @property
    def live(self) -> bool:
        """Whether collectives move data (a process group stands behind
        the mesh)."""
        return self._groups is not None

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.shape.values())

    def axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or a tuple of names) in mesh order, those of
        size 1 left out: the axes a collective over them spans."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes`` (mesh order, sizes above 1), ordered by their index
        over ``axes``."""
        return self._groups[self.axes(axes)]

    def __repr__(self):
        kind = ("" if self.live else ", one process" if self.devices
                is not None else ", shape-only")
        return f"Mesh({self.name} {self.axis_names}, at {self.coords}{kind})"


def _coords(rank: int, shape, names) -> dict[str, int]:
    out = {}
    for n, a in zip(reversed(shape), reversed(names)):
        out[a] = rank % n
        rank //= n
    return {a: out[a] for a in names}


def init_cards(rank: int, world_size: int, init_method: str,
               backend: str | None = None) -> None:
    """Join the process group as ``rank`` of ``world_size``, rendezvous at
    ``init_method`` (``tcp://localhost:<port>`` or ``file://<path>``).
    On the cards (backend ``"nccl"``, the default where CUDA is present)
    rank r takes card r first, so ``resolve_device(None)`` means its own
    card; ``"gloo"`` runs the ranks on the CPU."""
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        card = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)


def make_card_mesh(shape=(1, None), axis_names=("data", "model"),
                   device=None) -> Mesh:
    """A live mesh of ``shape`` over the process group (one ``None`` in
    ``shape`` takes what the world size leaves), ranks laid out row-major
    as ``init_device_mesh`` lays them, on ``device`` (``None`` = this
    rank's card; ``"cpu"`` with gloo).  Every rank calls it, in the same
    order as every other collective set-up."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    shape = list(shape)
    if None in shape:
        shape[shape.index(None)] = world // math.prod(
            n for n in shape if n is not None)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} does not cover {world} ranks")
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    dm = init_device_mesh(device.type, tuple(shape),
                          mesh_dim_names=tuple(axis_names))
    rank = dist.get_rank()
    coords = _coords(rank, shape, axis_names)
    live = [a for a, n in zip(axis_names, shape) if n > 1]
    all_coords = [_coords(r, shape, axis_names) for r in range(world)]
    groups = {(): None}
    for k in range(1, len(live) + 1):
        for axes in itertools.combinations(live, k):
            if k == 1:
                groups[axes] = dm.get_group(axes[0])
                continue
            # one group per setting of the other axes; every rank makes
            # all of them, in one order
            others = [a for a in axis_names if a not in axes]
            for fixed in itertools.product(*(range(shape[axis_names.index(
                    a)]) for a in others)):
                ranks = [r for r, c in enumerate(all_coords)
                         if all(c[a] == v for a, v in zip(others, fixed))]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axes] = g
    return Mesh(shape, axis_names, coords=coords, groups=groups,
                device=device)


def make_production_mesh(*, multi_pod: bool = False, coords=None) -> Mesh:
    """16x16 single-pod (256 cards) or 2x16x16 multi-pod (512), shape-only
    (the dry run), at rank 0's coordinates unless ``coords`` are given."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, coords=coords)


def make_host_mesh() -> Mesh:
    """The degenerate 1x1 mesh: one card, no collective."""
    return Mesh((1, 1), ("data", "model"))


def make_query_mesh(*, max_devices: int | None = None,
                    doc_shards: int | None = None, devices=None) -> Mesh:
    """The ``("data",)`` mesh over the local cards that the query engine
    (``core/engine.py``) data-parallels the query axis over, as the
    reference's ``make_query_mesh`` builds it over ``jax.local_devices()``.
    ``devices=None`` means every CUDA device (raises without one);
    ``max_devices`` keeps the first ones (at least 1, at most all).  The
    tests pass ``devices=["cpu"] * n``.

    ``doc_shards`` selects the 2-D ``(query x doc-shard)`` layout
    ``("data", "docs")``: the query axis data-parallels over the first
    axis while each ``docs`` group holds one contiguous slice of the
    document axis (``index.dense.shard_dense_index(..., devices=)``),
    merged across shards by ``core.engine.merge_shard_topk``.  The device
    count must be divisible by ``doc_shards``.  One process drives every
    card of the mesh: it has no process group."""
    import numpy as np
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=['cpu'] * n to build a query "
                "mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if devices and devices[0].type == "cuda":
        devices = [torch.device("cuda", torch.cuda.current_device()
                                if d.index is None else d.index)
                   for d in devices]
    if max_devices is not None:
        devices = devices[:max(1, min(max_devices, len(devices)))]
    if doc_shards is None:
        shape, names = (len(devices),), ("data",)
    else:
        doc_shards = int(doc_shards)
        if doc_shards < 1 or len(devices) % doc_shards:
            raise ValueError(
                f"doc_shards={doc_shards} must divide the device count "
                f"{len(devices)}")
        shape, names = (len(devices) // doc_shards, doc_shards), \
            ("data", "docs")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(shape, names, device=devices[0],
                devices=grid.reshape(shape))


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now (for
    ``init_method="tcp://localhost:<port>"``)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def memory_bytes() -> float:
    """The memory of the card in use (``total_memory`` of the current
    CUDA device), or the datasheet's ``HBM_BYTES`` without a card."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
    return HBM_BYTES


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak rate for a step whose arithmetic is in ``dtype``:
    the bf16 tensor cores for bf16 and fp16, else fp32 on the CUDA
    cores."""
    return PEAK_FLOPS_BF16 if dtype in (torch.bfloat16, torch.float16) \
        else PEAK_FLOPS_FP32

