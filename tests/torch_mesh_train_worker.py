"""The processes of ``tests/test_torch_mesh_train.py``.

    python tests/torch_mesh_train_worker.py rank <case_dir> <rank> <world>
    python tests/torch_mesh_train_worker.py unsharded <case_dir> <case>...
    python tests/torch_mesh_train_worker.py reference <case_dir> <case>

``rank``: one of ``world`` gloo ranks on the CPU.  For each mesh of
``MESHES`` it trains every case of ``<case_dir>/cases.json`` on the
port's mesh path: the reduced LM's weights (``<case>.npz``, the JAX
package's ``init_params`` draw) carried across by ``lm_from_arrays(...,
mesh=)``, ``STEPS`` AdamW steps of ``N_MICRO`` micro-batches on the case's
batches (each rank's share by ``shard_batch``), with remat; it records
each step's metrics and the shape of every moment shard it holds, and
saves the state on the mesh (``checkpoint.save(..., mesh=)``: the whole
leaves, gathered) to ``<case_dir>/<mesh>__<case>``.  Then the checkpoint
moves: ``MOVE_CASE``'s 2x2 state restored onto 4x1 and saved again
(``moved_4x1``); the reference's own checkpoint of ``REF_CASE``
(``ref_ckpt``, written by an ``unsharded`` process while the ranks
train) restored onto
2x2 and saved again (``ref_on_2x2``); and a copy of a checkpoint with one
leaf's bytes flipped restored on every rank, which must raise.  It writes
``rank<r>.npz``.

``unsharded``: the reference's unsharded ``jax.jit(make_train_step(...))``
of the cases named, on the same weights and batches; writes
``<case>__ref.npz`` each: the state after the steps, each step's metrics,
and each leaf's gradient floor (:func:`reference_steps`).  It writes
REF_CASE's state as the reference's own checkpoint (``ref_ckpt``) for the
ranks.

``reference``: the reference's own sharded train step of one case on a 2x2
mesh of four forced host devices (its ``_lm_train`` shardings: the
parameters by ``spec_tree``, the moments by ``zero1_sharding_tree``, the
batch over ``BATCH``), jitted with ``in_shardings``/``out_shardings``;
writes ``<case>__ref2x2.npz``.  It must be a process of its own: the
device-count flag is read at JAX's first use.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_worker import port_cfg, unflat  # noqa: E402

#: the meshes of the rank runs, (data, model)
MESHES = ((1, 4), (2, 2), (4, 1))
N_MICRO, STEPS = 2, 2
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=3)
#: the case whose 2x2 state moves onto 4x1 (its moments cut along the
#: layers on 2x2, along d_model on 4x1), and the case whose reference
#: checkpoint restores onto 2x2
MOVE_CASE, REF_CASE = "olmoe", "internlm2"
#: the batch of a step, rows x sequence
B, S = 8, 16
#: seconds a process waits for a file another one writes
WAIT = 240


def batches(data) -> list[dict]:
    return [{k: data[f"{k}{s}"] for k in ("tokens", "targets")}
            for s in range(STEPS)]


def wait_for(path: Path) -> Path:
    """``path`` once another process has written it."""
    t0 = time.time()
    while not path.exists():
        if time.time() - t0 > WAIT:
            raise TimeoutError(f"{path} did not come")
        time.sleep(0.1)
    return path


def load_case(case_dir: Path, name: str):
    """(the case's data, its weights as a nest of numpy arrays)."""
    data = np.load(wait_for(case_dir / f"{name}.npz"))
    return data, unflat({k[2:]: data[k] for k in data.files
                         if k.startswith("p/")})


def run_rank(case_dir: Path, rank: int, world: int) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer_lm as TT
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    torch.set_num_threads(1)
    mesh_lib.init_cards(rank, world, f"file://{case_dir / 'store'}",
                        backend="gloo")
    cases = {c["name"]: c for c in
             json.loads((case_dir / "cases.json").read_text())}
    out: dict = {}
    meshes = {}
    for shape in MESHES:
        mesh = meshes[shape] = mesh_lib.make_card_mesh(shape, device="cpu")
        for name, case in cases.items():
            cfg = port_cfg(case)
            data, tree = load_case(case_dir, name)
            lm = TT.lm_from_arrays(cfg, tree, "cpu", mesh=mesh)
            state = ts.init_state(lm)
            step = ts.make_train_step(
                functools.partial(TT.loss_fn, cfg, mesh=mesh),
                opt_lib.AdamWConfig(**OPT), n_micro=N_MICRO)
            key = f"{mesh.name}/{name}"
            seq = []
            for b in batches(data):
                batch = {k: torch.from_numpy(v) for k, v in b.items()}
                state, m = step(state, TT.shard_batch(cfg, mesh, batch,
                                                      N_MICRO))
                seq.append({k: float(v) for k, v in m.items()})
            for k in seq[0]:
                out[f"{key}/metrics/{k}"] = np.array([m[k] for m in seq])
            layout = opt_lib.mesh_layout(lm)
            held: dict = {}
            for n, t in state["opt"]["m"].items():
                held.setdefault(layout[n].key, []).append(tuple(t.shape))
            for k, shapes in held.items():
                stacked = layout[next(n for n in state["opt"]["m"]
                                      if layout[n].key == k)].layer
                out[f"{key}/mshape/{k}"] = np.array(
                    (len(shapes), *shapes[0]) if stacked is not None
                    else shapes[0])
            ckpt.save(case_dir / f"{mesh.name}__{name}", STEPS, state,
                      mesh=mesh, shardings=TT.state_specs(cfg, mesh))
        dist.barrier()

    def fresh(name, mesh):
        cfg = port_cfg(cases[name])
        state = ts.init_state(TT.TransformerLM(cfg, "cpu", mesh=mesh))
        return cfg, state

    # the 2x2 state of MOVE_CASE onto 4x1
    cfg, state = fresh(MOVE_CASE, meshes[(4, 1)])
    specs = TT.state_specs(cfg, meshes[(4, 1)])
    ckpt.restore(case_dir / f"2x2__{MOVE_CASE}", STEPS, state,
                 mesh=meshes[(4, 1)], shardings=specs)
    ckpt.save(case_dir / "moved_4x1", STEPS, state, mesh=meshes[(4, 1)],
              shardings=specs)
    # a leaf's bytes flipped: every rank's restore raises
    bad = case_dir / "corrupt"
    if rank == 0:
        shutil.copytree(case_dir / f"2x2__{MOVE_CASE}", bad)
        leaf = bad / f"step_{STEPS:08d}" / "params__embed.npy"
        raw = bytearray(leaf.read_bytes())
        raw[-1] ^= 0xFF
        leaf.write_bytes(bytes(raw))
    dist.barrier()
    cfg, state = fresh(MOVE_CASE, meshes[(2, 2)])
    try:
        ckpt.restore(bad, STEPS, state, mesh=meshes[(2, 2)],
                     shardings=TT.state_specs(cfg, meshes[(2, 2)]))
        out["corrupt_raised"] = np.array("")
    except IOError as e:
        out["corrupt_raised"] = np.array(str(e))
    # the reference's checkpoint of REF_CASE onto 2x2
    wait_for(case_dir / "ref_ckpt.done")
    cfg, state = fresh(REF_CASE, meshes[(2, 2)])
    specs = TT.state_specs(cfg, meshes[(2, 2)])
    ckpt.restore(case_dir / "ref_ckpt", STEPS, state, mesh=meshes[(2, 2)],
                 shardings=specs)
    ckpt.save(case_dir / "ref_on_2x2", STEPS, state, mesh=meshes[(2, 2)],
              shardings=specs)
    np.savez(case_dir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def jax_cfg(case: dict):
    """The reference's reduced config of ``case``, float32, no remat."""
    import jax.numpy as jnp
    from repro.configs.registry import get_arch
    cfg = get_arch(case["arch"]).reduced()[0]
    over = dict(case["overrides"])
    cf = over.pop("capacity_factor", None)
    if cf is not None:
        over["moe"] = dataclasses.replace(cfg.moe, capacity_factor=cf)
    return dataclasses.replace(cfg, dtype=jnp.float32, remat=False, **over)


def flat(tree, prefix: str = "") -> dict:
    """The leaves of a nest of dicts by "a/b/c" path, as numpy."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def reference_steps(jcfg, params, data) -> dict:
    """The reference's unsharded steps of the case's batches: the state
    after them ("params/...", "m/..."), each step's metrics
    ("metrics/<key>"), and each leaf's gradient floor over the steps
    ("floor/..."), with the summed learning rate ("lr_sum").  The floor
    (``test_torch_train_lm._floor``: the elements whose micro-batches'
    mean gradient lies below 1e-4 of the leaf's largest) is read off the
    first moments, whose increment a step is (1 - b1) times that gradient,
    clipped: a scale a relative floor does not see."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer_lm as JT
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    opt = jopt.AdamWConfig(**OPT)
    step = jax.jit(jts.make_train_step(functools.partial(JT.loss_fn, jcfg),
                                       opt, n_micro=N_MICRO))
    state, seq, floor = jts.init_state(params), [], None
    m_prev = {k: 0.0 for k in flat(params)}
    for b in batches(data):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        seq.append({k: float(v) for k, v in m.items()})
        m_now = flat(state["opt"]["m"])
        g = {k: np.abs(m_now[k] - opt.b1 * m_prev[k]) for k in m_now}
        f = {k: a < 1e-4 * a.max() for k, a in g.items()}
        floor = f if floor is None else {k: floor[k] | f[k] for k in f}
        m_prev = m_now
    out = {f"params/{k}": v for k, v in flat(state["params"]).items()}
    out |= {f"m/{k}": v for k, v in flat(state["opt"]["m"]).items()}
    out |= {f"floor/{k}": v for k, v in floor.items()}
    out |= {f"metrics/{k}": np.array([m[k] for m in seq]) for k in seq[0]}
    out["lr_sum"] = np.array(sum(m["lr"] for m in seq))
    return out, state


#: the reference's processes compute on one thread each, beside the ranks
XLA_ONE_THREAD = "--xla_cpu_multi_thread_eigen=false"


def draw_case(case_dir: Path, i: int, case: dict) -> None:
    """Case ``i``'s inputs, ``<case>.npz``: the reference's
    ``init_params`` draw from key i ("p/..."), and STEPS batches from
    numpy's seed i (targets -1 at a fifth of the places)."""
    import jax
    from repro.models import transformer_lm as JT
    jcfg = jax_cfg(case)
    params = jax.jit(functools.partial(JT.init_params, jcfg))(
        jax.random.key(i))
    rng = np.random.default_rng(i)
    out = {f"p/{k}": np.asarray(v, np.float32)
           for k, v in flat(params).items()}
    for s in range(STEPS):
        out[f"tokens{s}"] = rng.integers(0, jcfg.vocab, (B, S),
                                         dtype=np.int32)
        tgt = rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)
        tgt[rng.random((B, S)) < 0.2] = -1
        out[f"targets{s}"] = tgt
    tmp = case_dir / f"{case['name']}.tmp.npz"
    np.savez(tmp, **out)
    tmp.rename(case_dir / f"{case['name']}.npz")


def run_unsharded(case_dir: Path, names: list[str]) -> None:
    os.environ["XLA_FLAGS"] = XLA_ONE_THREAD
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import jax
    import jax.numpy as jnp
    from repro.train import checkpoint as jckpt
    order = [c["name"] for c in
             json.loads((case_dir / "cases.json").read_text())]
    cases = {c["name"]: c for c in
             json.loads((case_dir / "cases.json").read_text())}
    for name in names:
        draw_case(case_dir, order.index(name), cases[name])
    for name in names:
        data, tree = load_case(case_dir, name)
        params = jax.tree.map(jnp.asarray, tree)
        out, state = reference_steps(jax_cfg(cases[name]), params, data)
        np.savez(case_dir / f"{name}__ref.npz", **out)
        if name == REF_CASE:
            jckpt.save(case_dir / "ref_ckpt", STEPS, state)
            (case_dir / "ref_ckpt.done").touch()


def run_reference(case_dir: Path, name: str) -> None:
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count=4 {XLA_ONE_THREAD}"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec

    from repro import sharding as jsh
    from repro.models import transformer_lm as JT
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts

    case = next(c for c in json.loads((case_dir / "cases.json").read_text())
                if c["name"] == name)
    cfg = jax_cfg(case)
    data, tree = load_case(case_dir, name)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    prof = jsh.PROFILES[cfg.sharding_profile](mesh)
    params = jax.tree.map(jnp.asarray, tree)
    p_sh = jsh.spec_tree(params, JT.param_logical(cfg), mesh, prof)
    m_sh = jsh.zero1_sharding_tree(params, p_sh, mesh)
    rep = NamedSharding(mesh, PartitionSpec())
    s_sh = {"params": p_sh, "opt": {"m": m_sh, "v": m_sh, "step": rep}}
    b_sh = {k: jsh.named_sharding(mesh, (jsh.BATCH, None), (B, S), prof)
            for k in ("tokens", "targets")}
    step = jax.jit(jts.make_train_step(
        functools.partial(JT.loss_fn, cfg, mesh=mesh),
        jopt.AdamWConfig(**OPT), n_micro=N_MICRO),
        in_shardings=(s_sh, b_sh), out_shardings=(s_sh, rep))
    seq = []
    with mesh:
        state = jax.device_put(jts.init_state(params), s_sh)
        for b in batches(data):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            seq.append({k: float(v) for k, v in m.items()})
    out = {f"params/{k}": v for k, v in flat(state["params"]).items()}
    out |= {f"m/{k}": v for k, v in flat(state["opt"]["m"]).items()}
    out |= {f"metrics/{k}": np.array([m[k] for m in seq]) for k in seq[0]}
    np.savez(case_dir / f"{name}__ref2x2.npz", **out)


if __name__ == "__main__":
    what, case_dir = sys.argv[1], Path(sys.argv[2])
    if what == "rank":
        run_rank(case_dir, int(sys.argv[3]), int(sys.argv[4]))
    elif what == "unsharded":
        run_unsharded(case_dir, sys.argv[3:])
    else:
        run_reference(case_dir, sys.argv[3])
