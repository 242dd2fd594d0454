"""Logical-axis sharding rules (MaxText-style) for a mesh of cards (the port
of ``src/repro/sharding.py``).

Parameters and activations are annotated with *logical* axis names; the
per-arch profiles map logical axes onto mesh axes.  A rule whose mesh-axis
product does not divide the dimension is dropped at resolve time (falling
back to replication), so one profile works across mesh shapes.  The rules
are pure Python: a mesh is anything with ``axis_names`` and a ``shape``
mapping (``launch/mesh.py``'s meshes, or the reference's), and a spec is a
:class:`P`, a tuple with one entry a dimension (None, an axis name, or a
tuple of axis names, major first).  :func:`local_shape` and
:func:`local_slices` turn a spec into one rank's shard, the block that
GSPMD would place on the device at those mesh coordinates.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

# Canonical logical axis names used throughout the model zoo.
BATCH = "batch"          # global batch / token dim of activations
SEQ = "seq"              # sequence dim of activations
KV_SEQ = "kv_seq"        # sequence dim of a KV cache (SP for long decode)
EMBED = "embed"          # d_model
VOCAB = "vocab"          # vocabulary
Q_HEADS = "q_heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
MLP = "mlp"              # FFN hidden
EXPERTS = "experts"      # MoE expert dim
EXPERT_CAP = "expert_cap"
LAYERS = "layers"        # stacked-layer leading dim (never sharded)
NODES = "nodes"          # GNN node dim
EDGES = "edges"          # GNN edge dim
TABLE_ROWS = "table_rows"  # recsys embedding-table vocab rows
FEATURES = "features"    # generic trailing feature dim
CANDIDATES = "candidates"  # retrieval candidate dim


class P(tuple):
    """A partition spec: one entry a dimension, each None (replicated), an
    axis name, or a tuple of axis names (the first the major one).
    Trailing dimensions past its length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel mesh axes ('pod' folded in when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# ---------------------------------------------------------------------------
# profiles
# ---------------------------------------------------------------------------

def tp_profile(mesh) -> dict[str, tuple[str, ...]]:
    """Megatron-style tensor parallelism over the 'model' axis + DP batch."""
    dp = dp_axes(mesh)
    return {
        BATCH: dp,
        Q_HEADS: ("model",),
        KV_HEADS: ("model",),
        MLP: ("model",),
        VOCAB: ("model",),
        EXPERTS: ("model",),
        KV_SEQ: dp + ("model",),  # KV seq sharded over whatever batch leaves free
        TABLE_ROWS: ("model",),
        EDGES: dp,
        NODES: dp,
        CANDIDATES: dp + ("model",),
    }


def fsdp_profile(mesh) -> dict[str, tuple[str, ...]]:
    """ZeRO-3 style: parameter storage sharded over BOTH 'data' (EMBED dim)
    and 'model' (output dims); weights are all-gathered at use.  Used by
    archs whose head counts don't divide the TP degree (qwen2-1.5b,
    llama4-scout) and wherever param+optimizer memory dominates."""
    dp = dp_axes(mesh)
    return {
        BATCH: dp,
        EMBED: ("data",),      # ZeRO shard of the d_model dim of every weight
        Q_HEADS: ("model",),   # auto-dropped when not divisible
        HEAD_DIM: ("model",),  # picks up 'model' when q_heads dropped
        MLP: ("model",),
        VOCAB: ("model",),
        EXPERTS: ("model",),
        KV_SEQ: dp + ("model",),
        TABLE_ROWS: ("model",),
        EDGES: dp,
        NODES: dp,
        CANDIDATES: dp + ("model",),
    }


def zero3_profile(mesh) -> dict[str, tuple[str, ...]]:
    """Pure storage sharding: attention weights shard only on their d_model
    (EMBED) dim over 'data' (compute-local attention after the FSDP
    gather) while FFN/vocab keep 'model' TP."""
    dp = dp_axes(mesh)
    return {
        BATCH: dp,
        EMBED: ("data",),
        MLP: ("model",),
        VOCAB: ("model",),
        EXPERTS: ("model",),
        KV_SEQ: dp + ("model",),
        TABLE_ROWS: ("model",),
        EDGES: dp,
        NODES: dp,
        CANDIDATES: dp + ("model",),
    }


def light_profile(mesh) -> dict[str, tuple[str, ...]]:
    """Attention weights fully replicated (no gathers, no cross-shard
    contractions); FFN and vocab keep 'model' TP; optimizer moments are
    still ZeRO-1 over data.  For archs whose attention weights fit
    replicated."""
    dp = dp_axes(mesh)
    return {
        BATCH: dp,
        MLP: ("model",),
        VOCAB: ("model",),
        EXPERTS: ("model",),
        KV_SEQ: dp + ("model",),
        TABLE_ROWS: ("model",),
        EDGES: dp,
        NODES: dp,
        CANDIDATES: dp + ("model",),
    }


def dp_profile(mesh) -> dict[str, tuple[str, ...]]:
    """Pure data parallelism over EVERY mesh axis, weights replicated,
    optimizer ZeRO-1 over data: no TP collectives, one gradient all-reduce
    a step."""
    dp = dp_axes(mesh) + ("model",)
    return {
        BATCH: dp,
        KV_SEQ: dp,
        TABLE_ROWS: ("model",),
        EDGES: dp,
        NODES: dp,
        CANDIDATES: dp,
    }


def dp_ep_profile(mesh) -> dict[str, tuple[str, ...]]:
    """Pure-DP activations + expert weights sharded (EP over 'model', expert
    ff additionally over 'data'), for MoE archs whose dense parts fit
    replicated but whose expert bank doesn't."""
    dp = dp_axes(mesh) + ("model",)
    return {
        BATCH: dp,
        EXPERTS: ("model",),
        MLP: ("data",),        # expert ff dim ZeRO-sharded over data
        VOCAB: ("model",),
        EMBED: ("data",),      # embedding/unembed d-shard (vocab is huge)
        KV_SEQ: dp,
        TABLE_ROWS: ("model",),
        EDGES: dp,
        NODES: dp,
        CANDIDATES: dp,
    }


PROFILES = {"tp": tp_profile, "fsdp": fsdp_profile, "zero3": zero3_profile,
            "light": light_profile, "dp": dp_profile, "dp_ep": dp_ep_profile}


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def resolve_spec(logical: Sequence[str | None], dims: Sequence[int], mesh,
                 profile: Mapping[str, tuple[str, ...]]) -> P:
    """Map logical axes of one array to a :class:`P`, dropping rules whose
    mesh-axis product does not divide the dim (the longest prefix of the
    requested axes that divides it is kept), and never giving one mesh
    axis to two dims."""
    assert len(logical) == len(dims), (logical, dims)
    spec, used = [], set()
    for name, dim in zip(logical, dims):
        axes = tuple(profile.get(name, ())) if name else ()
        axes = tuple(a for a in axes if a in mesh.axis_names and a not in used)
        # longest prefix of the requested axes whose product divides the dim
        while axes and dim % _axes_size(mesh, axes) != 0:
            axes = axes[:-1]
        if axes:
            used.update(axes)
            spec.append(axes if len(axes) > 1 else axes[0])
        else:
            spec.append(None)
    return P(*spec)


class Ax:
    """Tree *leaf* holding the logical axis names of one parameter (a plain
    tuple would read as a node of the tree)."""

    __slots__ = ("names",)

    def __init__(self, *names: str | None):
        self.names = names

    def __repr__(self):
        return f"Ax{self.names}"


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _tree_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def pspec_tree(shape_tree, logical_tree, mesh, profile):
    """The :class:`P` of every leaf of ``shape_tree`` (a nest of dicts and
    lists whose leaves are shapes, tuples of ints, or anything with a
    ``shape``), from the parallel nest ``logical_tree`` of :class:`Ax`
    leaves."""
    return _tree_map(
        lambda a, ax: resolve_spec(ax.names, _shape(a), mesh, profile),
        shape_tree, logical_tree)


def zero1_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """ZeRO-1: extend a param spec with 'data' sharding on the first free,
    divisible dim, for optimizer moments, so they never replicate across
    the data axis even under pure-TP profiles."""
    if "data" not in mesh.axis_names:
        return spec
    used = set()
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a:
                used.add(a)
    if "data" in used:
        return spec
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % mesh.shape["data"] == 0 and dim > 1:
            entries[i] = "data"
            return P(*entries)
    return spec


def zero1_sharding_tree(shape_tree, specs, mesh) -> Any:
    return _tree_map(lambda a, s: zero1_spec(s, _shape(a), mesh),
                     shape_tree, specs)


# ---------------------------------------------------------------------------
# a rank's shard
# ---------------------------------------------------------------------------

def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: P, dim: int) -> tuple[str, ...]:
    """The mesh axes sharding dimension ``dim`` of ``spec`` (() past its
    end)."""
    return entry_axes(spec[dim]) if dim < len(spec) else ()


def shard_index(mesh, axes: tuple[str, ...], coords: Mapping[str, int]
                ) -> int:
    """The index of the shard at ``coords`` along a dim split over
    ``axes``: the coordinates read as one number, the first axis major."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


def local_shape(spec: P, shape: Sequence[int], mesh) -> tuple[int, ...]:
    """The shape of one rank's shard of an array of ``shape``."""
    return tuple(d // _axes_size(mesh, spec_axes(spec, i))
                 for i, d in enumerate(shape))


def local_slices(spec: P, shape: Sequence[int], mesh,
                 coords: Mapping[str, int]) -> tuple[slice, ...]:
    """The block of an array of ``shape`` that the rank at mesh
    ``coords`` (axis name -> index) holds."""
    out = []
    for i, d in enumerate(shape):
        axes = spec_axes(spec, i)
        n = d // _axes_size(mesh, axes)
        j = shard_index(mesh, axes, coords)
        out.append(slice(j * n, (j + 1) * n))
    return tuple(out)


def batch_share(batch: dict, spec: P, mesh, n_micro: int = 1) -> dict:
    """The rank's share of a whole training batch (tensors [B, ...]) for a
    step of ``n_micro`` micro-batches: micro-batch i is the batch's rows
    [i B/n, (i+1) B/n), the reference's split of the global batch, of
    which the rank takes the rows that ``spec`` (a micro-batch's, its
    leading dim by the batch's axes) gives it; the shares follow each
    other in micro-batch order, so the train step's split of the rank's
    rows gives each micro-batch's share.  The tensors are copied out of
    the batch; ``"rows"`` is B."""
    B = next(iter(batch.values())).shape[0]
    b = B // n_micro
    rows = local_slices(spec, (b,), mesh, mesh.coords)[0]
    out = {k: v.reshape(n_micro, b, *v.shape[1:])[:, rows]
           .reshape(-1, *v.shape[1:]).clone() for k, v in batch.items()}
    out["rows"] = B
    return out
