"""The collectives of the port's mesh paths, and their one record.

GSPMD inserts these by itself in the reference; in the port they are
explicit calls, and this module is their home.  Each call runs over the
process group of a set of mesh axes (``launch/mesh.py``; axes of size 1
are left out, and a call over none returns its input untouched) and
records its kind and bytes as ``src/repro/analysis/hlo_cost.py`` reckons
them from the compiled HLO: an all-reduce twice its operand's bytes, an
all-gather its gathered result's, the others the larger of operand and
result.  ``io_bytes`` keeps the operand's and the result's bytes, which
``hlo_cost`` adds to a step's memory traffic.

On a shape-only mesh (the dry run, tensors on ``meta``) each call makes
its result, of the right shape, and moves nothing; a tensor that holds
data on such a mesh raises, since it would be left unreduced.
"""
from __future__ import annotations

import contextlib

import torch

#: the reference's names of the four kinds
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")

_RECORDERS: list["Recorder"] = []


class Recorder:
    """The collectives called while it is open (:func:`recording`): bytes
    and calls by kind, and their operands' and results' bytes."""

    def __init__(self):
        self.bytes: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.io_bytes = 0.0

    def add(self, kind: str, volume: float, io: float) -> None:
        self.bytes[kind] = self.bytes.get(kind, 0.0) + volume
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.io_bytes += io

    @property
    def total(self) -> float:
        return sum(self.bytes.values())


@contextlib.contextmanager
def recording():
    """``with recording() as rec:`` records every collective of the block
    (recorders nest; each sees all calls)."""
    rec = Recorder()
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _record(kind: str, operand: torch.Tensor, result: torch.Tensor) -> None:
    ob, rb = _nbytes(operand), _nbytes(result)
    if kind == "all-reduce":
        vol = 2.0 * ob
    elif kind == "all-gather":
        vol = float(rb)
    else:
        vol = float(max(ob, rb))
    for rec in _RECORDERS:
        rec.add(kind, vol, ob + rb)


def _span(mesh, axes) -> tuple[tuple[str, ...], int]:
    """(the axes a call spans, the ranks on them)."""
    axes = mesh.axes(axes)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return axes, n


def _moves(mesh, x: torch.Tensor) -> bool:
    """Whether the call moves data: on a live mesh; a shape-only mesh takes
    only tensors without data."""
    if mesh.live:
        return True
    if x.device.type != "meta":
        raise RuntimeError(f"a collective over a shape-only mesh ({mesh}) "
                           f"got a tensor on {x.device}: it would be left "
                           f"unreduced")
    return False


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    import torch.distributed as dist
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The shards of ``x`` over ``axes`` concatenated along ``dim`` in
    the order of their index over ``axes`` (the first axis major)."""
    axes, n = _span(mesh, axes)
    if n == 1:
        return x
    dim %= x.dim()
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    if _moves(mesh, x):
        _gather_into(out, src, mesh.group(axes))
    if dim:
        out = out.movedim(0, dim).contiguous()
    _record("all-gather", x, out)
    return out


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum"
               ) -> torch.Tensor:
    """``x`` summed (``op="sum"``) or maximised (``"max"``) over the ranks
    of ``axes``, in place; returns ``x``."""
    import torch.distributed as dist
    axes, n = _span(mesh, axes)
    if n == 1:
        return x
    if _moves(mesh, x):
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(x, op=red, group=mesh.group(axes))
    _record("all-reduce", x, x)
    return x


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``x`` summed over the ranks of ``axes``, each keeping its block of
    ``dim`` (by its index over ``axes``)."""
    import torch.distributed as dist
    axes, n = _span(mesh, axes)
    if n == 1:
        return x
    dim %= x.dim()
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    if _moves(mesh, x):
        dist.reduce_scatter_tensor(out, src, group=mesh.group(axes))
    if dim:
        out = out.movedim(0, dim).contiguous()
    _record("reduce-scatter", x, out)
    return out


def all_to_all(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` [n, ...] (n the ranks of ``axes``): block j goes to the rank
    of index j, and block j of the result came from the rank of index j."""
    import torch.distributed as dist
    axes, n = _span(mesh, axes)
    if n == 1:
        return x
    assert x.shape[0] == n, (tuple(x.shape), n)
    src = x.contiguous()
    out = torch.empty_like(src)
    if _moves(mesh, x):
        dist.all_to_all_single(out, src, group=mesh.group(axes))
    _record("all-to-all", x, out)
    return out
