"""Checkpoints in the JAX package's on-disk format (the port of
``src/repro/train/checkpoint.py``), so either package restores what the
other wrote.

* **layout**: every leaf is its own ``.npy`` under ``step_<8 digits>/``,
  named by its JAX tree path ("params/layers/attn/wq" ->
  ``params__layers__attn__wq.npy``).  A tree is nested dicts of tensors,
  with ``nn.Module``s and dicts keyed by dotted parameter names (the
  optimizer's moments) inside.  Stacking is declared, as weight decay's
  is (``train/optimizer.py``): a name under a prefix that a module of the
  tree declares in ``stacked_prefixes`` (an LM's "layers.3.attn.wq", and
  its moments of that name) stacks on a leading L axis, as the JAX package
  stacks an LM's layers; any other name keeps its list index in the path,
  as the JAX package's zoo trees are lists ("params/cross/0/w").
  :func:`restore` reads a leaf from the other layout where the file has
  no leaf of the declared one.
* **bfloat16**: numpy has no bf16 without ``ml_dtypes``, which the port
  does not need: a bf16 leaf is written as the JAX package writes it, raw
  2-byte words under the header type ``'<V2'`` and the manifest dtype
  ``"bfloat16"``, and read back through ``int16``.
* **integrity manifest**: per-leaf SHA-256 of the raw bytes, dtype and
  shape; :func:`restore` checks them before any leaf reaches the tree.
* **atomicity**: writes go to ``<step>.tmp``, renamed once the manifest is
  written, so a crashed save never shadows the latest good one.
* **async**: :class:`AsyncCheckpointer` copies the leaves to host memory
  when called and hashes and writes them on a background thread.
* **on a mesh** (``mesh=`` and ``shardings=``, the specs of the tree's
  leaves by their JAX paths, as the reference's ``restore`` takes its
  ``shardings``): :func:`save` gathers each leaf whole from the ranks'
  shards, one rank writes it in the layout above and every rank waits for
  the write; :func:`restore` has each rank read its own slice of each leaf
  from the file (memory-mapped) after checking the whole file's digest.
  So a checkpoint moves between meshes of any shape and one card.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch import collectives as C
from repro_torch import sharding as sh

#: the header type ``ml_dtypes``' bfloat16 gives an ``.npy`` file
BF16_DESCR = "<V2"


def _declared(tree: Any) -> tuple[str, ...]:
    """The parameter-name prefixes that the modules of ``tree`` stack."""
    if isinstance(tree, nn.Module):
        return tuple(getattr(tree, "stacked_prefixes", ()))
    if isinstance(tree, dict):
        return tuple(p for sub in tree.values() for p in _declared(sub))
    return ()


def _leaves(tree: Any, prefix: tuple = ()):
    """(path parts, the leaf's dotted name in its container, leaf) of every
    leaf; dotted names split into parts."""
    if isinstance(tree, nn.Module):
        items = tree.named_parameters()
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        yield prefix, "", tree
        return
    for name, sub in items:
        parts = prefix + tuple(str(name).split("."))
        if isinstance(sub, (nn.Module, dict)):
            yield from _leaves(sub, parts)
        else:
            yield parts, str(name), sub


def _layouts(parts: tuple, stacked: bool):
    """(key, layer or None) of a leaf's path in the declared layout, then
    in the other (None where the path has no index): stacked, the path's
    first index is taken out of it and names the leaf's layer."""
    i = next((j for j, p in enumerate(parts) if p.isdigit()), None)
    flat = ("/".join(parts), None)
    if i is None:
        return flat, None
    stack = ("/".join(parts[:i] + parts[i + 1:]), int(parts[i]))
    return (stack, flat) if stacked else (flat, stack)


def _keyed(tree: Any) -> dict[str, list]:
    """Declared key -> [(layer or None, leaf, the other layout's (key,
    layer) or None)]: the leaves of a stacked key are that leaf's
    layers."""
    prefixes = _declared(tree)
    out: dict[str, list] = {}
    for parts, name, leaf in _leaves(tree):
        (key, layer), other = _layouts(parts, bool(prefixes) and
                                       name.startswith(prefixes))
        out.setdefault(key, []).append((layer, leaf, other))
    return out


def _host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of a tensor and its dtype's name; bf16 as raw words."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _snapshot(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    """JAX tree path -> (host array, dtype name), layers stacked."""
    flat = {}
    for key, entries in _keyed(tree).items():
        if entries[0][0] is None:
            flat[key] = _host(entries[0][1])
        else:
            arrs = [_host(leaf) for _, leaf, _ in sorted(entries,
                                                         key=lambda e: e[0])]
            flat[key] = (np.stack([a for a, _ in arrs]), arrs[0][1])
    return flat


def _write_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _write(ckpt_dir: str | Path, step: int, flat: dict) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": {}}
    for key, (arr, dtype) in flat.items():
        fname = key.replace("/", "__") + ".npy"
        _write_npy(tmp / fname, arr, dtype)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype,
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
        }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _flat_specs(shardings: Any, prefix: str = "") -> dict[str, sh.P]:
    """The specs of a tree of them (nested dicts and lists,
    :class:`sharding.P` leaves) by JAX path ("params/layers/attn/wq",
    "params/cross/0/w")."""
    if isinstance(shardings, (dict, list)):
        out = {}
        items = shardings.items() if isinstance(shardings, dict) else \
            enumerate(shardings)
        for k, v in items:
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: sh.P(*shardings)}


def _local_block(entries: list) -> torch.Tensor:
    """The rank's block of a leaf: its layers stacked, or the leaf."""
    if entries[0][0] is None:
        return entries[0][1].detach()
    return torch.stack([leaf.detach() for _, leaf, _ in
                        sorted(entries, key=lambda e: e[0])])


def _writer(mesh) -> bool:
    return all(c == 0 for c in mesh.coords.values())


def _gathered(tree: Any, mesh, specs: dict) -> dict:
    """:func:`_snapshot` of the whole leaves, gathered from every rank's
    shards by their ``specs``; empty on every rank but the writer.  The
    leaves go by path: a rank that holds some layers' moments alone meets
    their keys in another order."""
    flat = {}
    for key, entries in sorted(_keyed(tree).items()):
        spec = specs[key]
        block = _local_block(entries)
        for d in range(block.dim()):
            block = C.all_gather(block, mesh, sh.spec_axes(spec, d), d)
        if _writer(mesh):
            flat[key] = _host(block)
    return flat


@torch.no_grad()
def save(ckpt_dir: str | Path, step: int, tree: Any, *, mesh=None,
         shardings: Any = None) -> Path:
    """Synchronous atomic save. Returns the final directory.  On ``mesh``
    every rank calls it with its shards and ``shardings`` (see the module's
    docstring)."""
    if mesh is None:
        return _write(ckpt_dir, step, _snapshot(tree))
    import torch.distributed as dist
    flat = _gathered(tree, mesh, _flat_specs(shardings))
    if _writer(mesh):
        _write(ckpt_dir, step, flat)
    dist.barrier()
    return Path(ckpt_dir) / f"step_{step:08d}"


class AsyncCheckpointer:
    """Snapshot-on-call, write-in-background. One outstanding save at a time
    (the next save waits — bounded memory)."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save_async(self, step: int, tree: Any):
        self.wait()
        flat = _snapshot(tree)                      # device->host copy

        def work():
            try:
                _write(self.ckpt_dir, step, flat)
                self._gc()
            except Exception as e:  # noqa: BLE001
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self):
        steps = sorted(self.ckpt_dir.glob("step_????????"))
        for old in steps[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = sorted(Path(ckpt_dir).glob("step_????????"))
    return int(steps[-1].name.split("_")[1]) if steps else None


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _digest(arr: np.ndarray) -> str:
    """SHA-256 of an array's raw bytes, read in pieces (a memory-mapped
    leaf is not copied whole)."""
    h = hashlib.sha256()
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    for i in range(0, raw.size, 1 << 26):
        h.update(raw[i:i + (1 << 26)])
    return h.hexdigest()


def _restore_mesh(d: Path, leaves: dict, target: Any, mesh,
                  specs: dict) -> None:
    """Each leaf of ``target`` (the rank's shards) from its slice of the
    file, by ``specs``, after the whole file's digest."""
    for key, entries in _keyed(target).items():
        if key not in leaves:
            raise KeyError(f"checkpoint has no leaf {key!r}")
        meta = leaves[key]
        arr = np.load(d / meta["file"], mmap_mode="r")
        if _digest(arr) != meta["sha256"]:
            raise IOError(f"checkpoint corruption in leaf {key!r}")
        block = sh.local_slices(specs[key], arr.shape, mesh, mesh.coords)
        src = _tensor(np.array(arr[block]), meta["dtype"])
        want = tuple(_local_block(entries).shape)
        if tuple(src.shape) != want:
            raise ValueError(f"shape mismatch for {key}: a slice "
                             f"{tuple(src.shape)} of {tuple(arr.shape)} vs "
                             f"{want}")
        if entries[0][0] is None:
            entries[0][1].copy_(src)
            continue
        for i, (_, leaf, _) in enumerate(sorted(entries,
                                                key=lambda e: e[0])):
            leaf.copy_(src[i])


@torch.no_grad()
def restore(ckpt_dir: str | Path, step: int, target: Any, *, mesh=None,
            shardings: Any = None) -> Any:
    """Restore into ``target``'s tensors, in place, after checking every
    leaf's digest and shape; returns ``target``.  A leaf missing in the
    declared layout is read from the other (a stacked leaf's layer from
    its indexed path, an indexed leaf from its stack).  On ``mesh`` the
    tensors are the rank's shards, each read from its slice of the leaf by
    ``shardings`` (the module's docstring), in the declared layout."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    if mesh is not None:
        _restore_mesh(d, leaves, target, mesh, _flat_specs(shardings))
        return target
    stacks: dict[str, torch.Tensor] = {}   # the other layout's, read once

    def load(key: str) -> torch.Tensor:
        meta = leaves[key]
        arr = np.load(d / meta["file"])
        if hashlib.sha256(arr.tobytes()).hexdigest() != meta["sha256"]:
            raise IOError(f"checkpoint corruption in leaf {key!r}")
        return _tensor(arr, meta["dtype"])

    def check(key, got, want):
        if tuple(got) != tuple(want):
            raise ValueError(f"shape mismatch for {key}: {tuple(got)} vs "
                             f"{tuple(want)}")

    for key, entries in _keyed(target).items():
        stacked = entries[0][0] is not None
        if key in leaves:
            src = load(key)
            want = tuple(entries[0][1].shape)
            check(key, src.shape, (len(entries), *want) if stacked else want)
            for layer, leaf, _ in entries:
                leaf.copy_(src[layer] if stacked else src)
            continue
        for layer, leaf, other in entries:
            if other is None or other[0] not in leaves:
                raise KeyError(f"checkpoint has no leaf {key!r}")
            if other[1] is None:
                src = load(other[0])
            else:
                if other[0] not in stacks:
                    stacks[other[0]] = load(other[0])
                src = stacks[other[0]][other[1]]
            check(other[0], src.shape, leaf.shape)
            leaf.copy_(src)
    return target
