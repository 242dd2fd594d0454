"""The processes of ``tests/test_torch_mesh_lm.py``.

    python tests/torch_mesh_worker.py rank <case_dir> <rank> <world>
    python tests/torch_mesh_worker.py reference <case_dir> <case>

``rank``: one of ``world`` gloo ranks on the CPU.  For each mesh of
``MESHES`` it runs every case of ``<case_dir>/cases.json`` on the port's
mesh path: the reduced LM's weights (``<case>.npz``, the JAX package's
``init_params`` draw) carried across by ``lm_from_arrays(..., mesh=)``, a
prefill of the case's tokens and 3 decode steps, the logits gathered from
their shards.  An MoE case's prefill runs once more with every layer's
routes pinned to other experts (``expert_idx``), beside the one-card
prefill pinned alike; and each case's ``init_params(..., mesh=)`` is held
to the rank's slices of the one-card draw from the same seed.  It writes
``rank<r>.npz``: the gathered logits, each MoE layer's routing and drops,
the pinned prefills' logits, the parameters whose shard differs from the
one-card draw, and the shape of every shard it held.

``reference``: the reference's own sharded run of one case on a 2x2 mesh of
four forced host devices (its ``spec_tree`` shardings, jitted with
``in_shardings``/``out_shardings``); writes ``<case>__ref2x2.npz``.  It
must be a process of its own: the device-count flag is read at JAX's first
use.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

#: the meshes of the rank runs, (data, model)
MESHES = ((1, 4), (2, 2), (4, 1))
DECODE_STEPS = 3


def unflat(flat: dict) -> dict:
    """A nest of dicts from "a/b/c" keys."""
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def port_cfg(case: dict):
    import torch
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(case["arch"]).reduced()[0]
    over = dict(case["overrides"])
    cf = over.pop("capacity_factor", None)
    if cf is not None:
        over["moe"] = dataclasses.replace(cfg.moe, capacity_factor=cf)
    return dataclasses.replace(cfg, dtype=torch.float32, **over)


def run_rank(case_dir: Path, rank: int, world: int) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import collectives as C
    from repro_torch import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer_lm as TT

    torch.set_num_threads(1)
    mesh_lib.init_cards(rank, world, f"file://{case_dir / 'store'}",
                        backend="gloo")
    cases = json.loads((case_dir / "cases.json").read_text())
    out = {}
    for shape in MESHES:
        mesh = mesh_lib.make_card_mesh(shape, device="cpu")
        for case in cases:
            cfg = port_cfg(case)
            data = np.load(case_dir / f"{case['name']}.npz")
            tree = unflat({k[2:]: data[k] for k in data.files
                           if k.startswith("p/")})
            lm = TT.lm_from_arrays(cfg, tree, "cpu", mesh=mesh)
            toks = torch.from_numpy(data["tokens"])
            nxt = torch.from_numpy(data["next"])
            B, P = toks.shape
            specs = TT.serve_specs(cfg, mesh, B, P, case["cache_len"])
            rows = sh.local_slices(specs["tokens"], (B, P), mesh,
                                   mesh.coords)[0]
            cache = TT.init_kv_cache(cfg, B, case["cache_len"],
                                     device="cpu", mesh=mesh)
            vocab_ax = sh.spec_axes(specs["logits"], 1)
            batch_ax = sh.spec_axes(specs["logits"], 0)

            def whole(logits):
                logits = C.all_gather(logits, mesh, vocab_ax, 1)
                return C.all_gather(logits, mesh, batch_ax, 0).numpy()

            metrics: list = []
            with torch.no_grad():
                lg, _ = TT.prefill(cfg, lm, toks[rows], cache,
                                   metrics=metrics, mesh=mesh)
                got = [whole(lg)]
                for j in range(DECODE_STEPS):
                    lg, _ = TT.decode_step(cfg, lm, nxt[j][rows], cache,
                                           P + j, metrics=metrics, mesh=mesh)
                    got.append(whole(lg))
            key = f"{mesh.name}/{case['name']}"
            out[f"{key}/logits"] = np.stack(got)
            if cfg.moe:
                out[f"{key}/pinned"] = pinned_prefill(cfg, lm, tree, toks,
                                                      case, mesh, whole)
            out[f"{key}/init_differs"] = np.array(
                init_differs(cfg, mesh), dtype=str)
            if metrics:
                out[f"{key}/dropped"] = np.array(
                    [int(m["dropped"]) for m in metrics])
                out[f"{key}/expert_idx"] = np.concatenate(
                    [m["expert_idx"].reshape(-1).numpy() for m in metrics])
            for name, p in lm.named_parameters():
                out[f"{key}/shape/{name}"] = np.array(p.shape)
            out[f"{key}/shape/cache"] = np.array(cache["k"].shape)
        dist.barrier()
    np.savez(case_dir / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def pinned_prefill(cfg, lm, tree, toks, case, mesh, whole) -> np.ndarray:
    """[2, B, vocab]: the prefill of ``toks`` on the mesh and on one card
    (``lm_from_arrays`` of ``tree`` without a mesh), every MoE layer's
    routes pinned to the next experts of the one-card routing's picks."""
    import torch
    from repro_torch import sharding as sh
    from repro_torch.models import transformer_lm as TT
    one = TT.lm_from_arrays(cfg, tree, "cpu")
    B, P = toks.shape
    metrics: list = []
    with torch.no_grad():
        TT.prefill(cfg, one, toks, TT.init_kv_cache(cfg, B, P, device="cpu"),
                   metrics=metrics)
        pins = [(m["expert_idx"] + 1) % cfg.moe.n_experts for m in metrics]
        want, _ = TT.prefill(cfg, one, toks, TT.init_kv_cache(
            cfg, B, P, device="cpu"), expert_idx=pins)
        rows = sh.local_slices(TT.serve_specs(cfg, mesh, B, P, P)["tokens"],
                               (B, P), mesh, mesh.coords)[0]
        got, _ = TT.prefill(cfg, lm, toks[rows], TT.init_kv_cache(
            cfg, B, P, device="cpu", mesh=mesh), mesh=mesh, expert_idx=pins)
    return np.stack([whole(got), want.numpy()])


def init_differs(cfg, mesh) -> list[str]:
    """The parameters of ``init_params(cfg, seed 0, mesh=mesh)`` whose
    shard is not the rank's slice of the one-card draw from seed 0."""
    import torch
    from repro_torch import sharding as sh
    from repro_torch.models import transformer_lm as TT
    shards = TT.init_params(cfg, torch.Generator().manual_seed(0), mesh=mesh)
    one = dict(TT.init_params(cfg, torch.Generator().manual_seed(0))
               .named_parameters())
    return [name for name, p in shards.named_parameters()
            if not torch.equal(p, one[name][sh.local_slices(
                shards.spec(name), one[name].shape, mesh, mesh.coords)])]


def run_reference(case_dir: Path, name: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding

    from repro import sharding as jsh
    from repro.configs.registry import get_arch
    from repro.models import transformer_lm as JT

    case = next(c for c in json.loads((case_dir / "cases.json").read_text())
                if c["name"] == name)
    cfg = get_arch(case["arch"]).reduced()[0]
    over = dict(case["overrides"])
    cf = over.pop("capacity_factor", None)
    if cf is not None:
        over["moe"] = dataclasses.replace(cfg.moe, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, dtype=jnp.float32, remat=False, **over)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    prof = jsh.PROFILES[cfg.sharding_profile](mesh)
    data = np.load(case_dir / f"{name}.npz")
    params = unflat({k[2:]: jnp.asarray(data[k]) for k in data.files
                     if k.startswith("p/")})
    p_sh = jsh.spec_tree(params, JT.param_logical(cfg), mesh, prof)
    toks, nxt = data["tokens"], data["next"]
    B, P = toks.shape
    T = case["cache_len"]
    cache = JT.init_kv_cache(cfg, B, T)
    c_sh = jsh.spec_tree(cache, JT.kv_cache_logical(), mesh, prof)
    tok_sh = jsh.named_sharding(mesh, (jsh.BATCH, None), (B, P), prof)
    one_sh = jsh.named_sharding(mesh, (jsh.BATCH, None), (B, 1), prof)
    lg_sh = jsh.named_sharding(mesh, (jsh.BATCH, jsh.VOCAB), (B, cfg.vocab),
                               prof)
    rep = NamedSharding(mesh, jax.sharding.PartitionSpec())
    with mesh:
        params = jax.device_put(params, p_sh)
        cache = jax.device_put(cache, c_sh)
        pre = jax.jit(lambda p, t, c: JT.prefill(cfg, p, t, c, mesh=mesh),
                      in_shardings=(p_sh, tok_sh, c_sh),
                      out_shardings=(lg_sh, c_sh))
        dec = jax.jit(lambda p, t, c, pos: JT.decode_step(cfg, p, t, c, pos,
                                                          mesh=mesh),
                      in_shardings=(p_sh, one_sh, c_sh, rep),
                      out_shardings=(lg_sh, c_sh))
        lg, cache = pre(params, jnp.asarray(toks), cache)
        got = [np.asarray(lg)]
        for j in range(DECODE_STEPS):
            lg, cache = dec(params, jnp.asarray(nxt[j]), cache,
                            jnp.int32(P + j))
            got.append(np.asarray(lg))
    np.savez(case_dir / f"{name}__ref2x2.npz", logits=np.stack(got))


if __name__ == "__main__":
    what, case_dir = sys.argv[1], Path(sys.argv[2])
    if what == "rank":
        run_rank(case_dir, int(sys.argv[3]), int(sys.argv[4]))
    else:
        run_reference(case_dir, sys.argv[3])
