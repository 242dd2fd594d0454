"""The processes of ``tests/test_torch_mesh_zoo.py``.

    python tests/torch_mesh_zoo_worker.py rank <case_dir> <rank> <world>
    python tests/torch_mesh_zoo_worker.py unsharded <case_dir> <case>...
    python tests/torch_mesh_zoo_worker.py reference <case_dir> <case>

``rank``: one of ``world`` gloo ranks on the CPU.  For each mesh of
``MESHES`` and each case of ``CASES`` (the zoo's reduced configs; GAT
twice, node-level and with a molecule-style mean readout), from the
reference's ``init_params`` draw (``<case>.npz``) carried across by
``from_arrays(..., mesh=)``: the serve outputs (``forward`` of the first
batch, and a recsys model's ``retrieval_score`` of its first row against
``N_CAND`` candidates), gathered from the ranks; then ``STEPS`` AdamW
steps of the port's sharded train step (a recsys batch cut by
``embedding.shard_batch``, a graph padded to 128 x the mesh's size and
cut by ``gnn.shard_graph``, as ``launch.steps`` does), each step's
metrics, the shape of every moment shard, and the state saved on the mesh
(``checkpoint.save(..., mesh=)``: the whole leaves, gathered) to
``<case_dir>/<mesh>__<case>``; ``MICRO_CASES`` also take STEPS steps of
``N_MICRO`` micro-batches each on 4x1 (``shard_batch(..., n_micro=)``),
saved to ``micro_4x1__<case>``.  Then the checkpoints move: the 2x2 states
of ``MOVE_CASES`` restored onto 4x1 and saved again
(``moved_4x1__<case>``); the reference's own checkpoint of ``REF_CKPT``
(``ref_ckpt``, written by an ``unsharded`` process) restored onto 2x2 and
saved again (``ref_on_2x2``); and a copy of a checkpoint with one leaf's
bytes flipped restored on every rank, which must raise.  It writes
``rank<r>.npz``.

``unsharded``: draws the cases named (the reference's ``init_params`` from
key i, the batches from numpy's seed i) and runs the reference's
unsharded ``jax.jit(make_train_step(...))``, ``forward`` and
``retrieval_score`` on them; writes ``<case>__ref.npz`` each (and
``<case>__ref_micro.npz``, its steps in N_MICRO micro-batches, for
MICRO_CASES), and REF_CKPT's state as the reference's own checkpoint.

``reference``: the reference's own sharded train step of one recsys case
on a 2x2 mesh of four forced host devices (its ``_recsys_bundle``
shardings), jitted with ``in_shardings``/``out_shardings``; writes
``<case>__ref2x2.npz``.  A process of its own: the device-count flag is
read at JAX's first use.
"""
from __future__ import annotations

import functools
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

#: case -> its arch (gat-molecule: a reduced GAT with a mean readout over
#: packed graphs)
CASES = {"dcn-v2": "dcn-v2", "autoint": "autoint", "dien": "dien",
         "mind": "mind", "gat": "gat-cora", "gat-molecule": "gat-cora"}
#: the meshes of the rank runs, (data, model)
MESHES = ((1, 4), (2, 2), (4, 1))
STEPS = 2
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=3)
#: a recsys batch's rows (4 a rank on 4x1), a retrieval's candidates
B, N_CAND = 16, 64
#: the cases whose 2x2 state moves onto 4x1 and onto one card (their
#: tables cut over model on 2x2, whole on 4x1), the case whose reference
#: checkpoint restores onto 2x2, and the leaf that is corrupted
MOVE_CASES = ("dcn-v2", "mind")
REF_CKPT = "dien"
#: the cases also stepped in N_MICRO micro-batches on 4x1 (2 rows a rank
#: each): DIEN's rolled negatives and MIND's in-batch softmax span a
#: micro-batch of the global batch, not a rank's block of it
MICRO_CASES = ("dien", "mind")
N_MICRO = 2
CORRUPT = ("dcn-v2", "params__table.npy")
#: seconds a process waits for a file another one writes
WAIT = 240
#: the reference's processes compute on one thread each, beside the ranks
XLA_ONE_THREAD = "--xla_cpu_multi_thread_eigen=false"


def wait_for(path: Path) -> Path:
    """``path`` once another process has written it."""
    t0 = time.time()
    while not path.exists():
        if time.time() - t0 > WAIT:
            raise TimeoutError(f"{path} did not come")
        time.sleep(0.1)
    return path


def flat(tree, prefix: str = "") -> dict:
    """The leaves of a nest of dicts and lists by "a/0/c" path, as
    numpy."""
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def unflat(leaves: dict) -> dict:
    """A nest of dicts from "a/0/c" keys (list indices as keys, which
    ``from_arrays`` reads)."""
    tree: dict = {}
    for key, val in leaves.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def is_gat(name: str) -> bool:
    return CASES[name] == "gat-cora"


def port_cfg(name: str):
    """The port's reduced config of case ``name``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.gnn import GATConfig
    if name == "gat-molecule":
        return GATConfig(name="gat-molecule", n_layers=2, d_hidden=8,
                         n_heads=4, d_feat=9, n_classes=2, readout="mean")
    return get_arch(CASES[name]).reduced()[0]


def jax_cfg(name: str):
    """The reference's reduced config of case ``name``."""
    from repro.configs.registry import get_arch
    from repro.models.gnn import GATConfig
    if name == "gat-molecule":
        return GATConfig(name="gat-molecule", n_layers=2, d_hidden=8,
                         n_heads=4, d_feat=9, n_classes=2, readout="mean")
    return get_arch(CASES[name]).reduced()[0]


def _recsys_batch(name: str, cfg, rng) -> dict:
    if name == "dcn-v2":
        return {"dense": rng.standard_normal((B, cfg.n_dense),
                                             dtype=np.float32),
                "cat": rng.integers(0, min(cfg.vocabs), (B, cfg.n_sparse),
                                    dtype=np.int32),
                "label": rng.integers(0, 2, B, dtype=np.int32)}
    if name == "autoint":
        return {"cat": rng.integers(0, min(cfg.vocabs), (B, cfg.n_sparse),
                                    dtype=np.int32),
                "label": rng.integers(0, 2, B, dtype=np.int32)}
    T = cfg.seq_len
    out = {"hist_items": rng.integers(0, cfg.item_vocab, (B, T),
                                      dtype=np.int32),
           "hist_mask": (rng.random((B, T)) < 0.8).astype(np.float32),
           "target_item": rng.integers(0, cfg.item_vocab, B,
                                       dtype=np.int32)}
    if name == "dien":
        out |= {"hist_cates": rng.integers(0, cfg.cate_vocab, (B, T),
                                           dtype=np.int32),
                "target_cate": rng.integers(0, cfg.cate_vocab, B,
                                            dtype=np.int32),
                "label": rng.integers(0, 2, B, dtype=np.int32)}
    return out


def _graph(name: str, cfg, rng) -> dict:
    from repro_torch.models import sampler
    if name == "gat-molecule":
        return sampler.pack_molecule_batch(rng, 8, 6, 12, cfg.d_feat,
                                           cfg.n_classes)
    N, E = 64, 256
    return {"x": rng.standard_normal((N, cfg.d_feat), dtype=np.float32),
            "src": rng.integers(0, N, E, dtype=np.int32),
            "dst": rng.integers(0, N, E, dtype=np.int32),
            "labels": rng.integers(0, cfg.n_classes, N, dtype=np.int32),
            "label_mask": rng.random(N) < 0.7}


def batches(data) -> list[dict]:
    """The case's STEPS batches from its npz."""
    return [{k[len(f"b{s}/"):]: data[k] for k in data.files
             if k.startswith(f"b{s}/")} for s in range(STEPS)]


def serve_batch(name: str, data) -> dict:
    """The first batch without its label."""
    return {k: v for k, v in batches(data)[0].items() if k != "label"}


def retrieval_batch(name: str, data) -> dict:
    """The first row's context and the case's candidates."""
    out = {k: v[:1] for k, v in serve_batch(name, data).items()
           if k not in ("target_item", "target_cate")}
    out["candidates"] = data["candidates"]
    return out


def item_vocab(name: str, cfg) -> int:
    return cfg.vocabs[-1] if name in ("dcn-v2", "autoint") \
        else cfg.item_vocab


def draw_case(case_dir: Path, i: int, name: str) -> None:
    """Case ``i``'s inputs, ``<case>.npz``: the reference's
    ``init_params`` draw from key i ("p/..."), STEPS batches from numpy's
    seed i ("b<s>/..."), and a recsys case's candidates."""
    import jax
    from repro.configs.registry import get_arch
    cfg = jax_cfg(name)
    mod = get_arch(CASES[name]).module
    params = jax.jit(functools.partial(mod.init_params, cfg))(
        jax.random.key(i))
    rng = np.random.default_rng(i)
    out = {f"p/{k}": np.asarray(v, np.float32)
           for k, v in flat(params).items()}
    for s in range(STEPS):
        b = _graph(name, cfg, rng) if is_gat(name) else \
            _recsys_batch(name, cfg, rng)
        out |= {f"b{s}/{k}": v for k, v in b.items()}
    if not is_gat(name):
        out["candidates"] = rng.integers(0, item_vocab(name, cfg), N_CAND,
                                         dtype=np.int32)
    tmp = case_dir / f"{name}.tmp.npz"
    np.savez(tmp, **out)
    tmp.rename(case_dir / f"{name}.npz")


def load_case(case_dir: Path, name: str):
    """(the case's data, its weights as a nest of numpy arrays)."""
    data = np.load(wait_for(case_dir / f"{name}.npz"))
    return data, unflat({k[2:]: data[k] for k in data.files
                         if k.startswith("p/")})


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _port_module(name: str):
    from repro_torch.configs.registry import get_arch
    return get_arch(CASES[name]).module


def _tensors(batch: dict) -> dict:
    import torch
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _graph_loss(cfg, mod, mesh):
    from repro_torch.launch.steps import GNN_PAD_MULTIPLE, _pad_graph

    def loss(params, batch):
        graph = mod.shard_graph(mesh, _pad_graph(
            batch, GNN_PAD_MULTIPLE * mesh.size))
        return mod.loss_fn(cfg, params, graph, mesh=mesh)
    return loss


def serve_outputs(name: str, cfg, mod, params, data, mesh) -> dict:
    """The case's serve outputs on ``mesh``, gathered from the ranks."""
    import torch
    from repro_torch import collectives as C
    from repro_torch import sharding as sh
    from repro_torch.launch.steps import GNN_PAD_MULTIPLE, _pad_graph
    from repro_torch.models.recsys import embedding as E
    out = {}
    with torch.no_grad():
        if is_gat(name):
            whole = _tensors(batches(data)[0])
            graph = mod.shard_graph(mesh, _pad_graph(
                whole, GNN_PAD_MULTIPLE * mesh.size))
            y = mod.forward(cfg, params, graph, mesh=mesh)
            if cfg.readout != "mean":
                y = C.all_gather(y, mesh,
                                 mod._node_axes(mesh, graph["n_nodes"]), 0)
            n = whole["node_counts"].shape[0] if cfg.readout == "mean" \
                else whole["x"].shape[0]
            out["serve"] = y[:n].numpy()
            return out
        b = E.shard_batch(mesh, _tensors(serve_batch(name, data)))
        y = mod.forward(cfg, params, b, mesh=mesh)
        key = next(k for k in b if k != "rows")
        out["serve"] = C.all_gather(y, mesh, E.batch_axes(mesh, b, key),
                                    0).numpy()
        r = _tensors(retrieval_batch(name, data))
        spec = E.row_spec(mesh, (N_CAND,), sh.CANDIDATES)
        r["candidates"] = r["candidates"][sh.local_slices(
            spec, (N_CAND,), mesh, mesh.coords)]
        r["rows"] = N_CAND
        y = mod.retrieval_score(cfg, params, r, mesh=mesh)
        out["retrieval"] = C.all_gather(
            y, mesh, mesh.axes(sh.spec_axes(spec, 0)), 0).numpy()
    return out


def train_on_mesh(name: str, cfg, mod, tree, data, mesh, n_micro=1):
    """STEPS AdamW steps of the port's sharded train step from the weights
    ``tree``: (the state after them, each step's metrics)."""
    from repro_torch.models.recsys import embedding as E
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    state = ts.init_state(mod.from_arrays(cfg, tree, "cpu", mesh=mesh))
    loss = _graph_loss(cfg, mod, mesh) if is_gat(name) else \
        functools.partial(mod.loss_fn, cfg, mesh=mesh)
    step = ts.make_train_step(loss, opt_lib.AdamWConfig(**OPT),
                              n_micro=n_micro)
    seq = []
    for b in batches(data):
        b = _tensors(b)
        if not is_gat(name):
            b = E.shard_batch(mesh, b, n_micro=n_micro)
        state, m = step(state, b)
        seq.append({k: float(v) for k, v in m.items()})
    return state, {k: np.array([m[k] for m in seq]) for k in seq[0]}


def run_rank(case_dir: Path, rank: int, world: int) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import param_tree as P
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_step as ts

    torch.set_num_threads(1)
    mesh_lib.init_cards(rank, world, f"file://{case_dir / 'store'}",
                        backend="gloo")
    out: dict = {}
    meshes = {}
    for shape in MESHES:
        mesh = meshes[shape] = mesh_lib.make_card_mesh(shape, device="cpu")
        for name in CASES:
            cfg, mod = port_cfg(name), _port_module(name)
            data, tree = load_case(case_dir, name)
            key = f"{mesh.name}/{name}"
            params = mod.from_arrays(cfg, tree, "cpu", mesh=mesh)
            for k, v in serve_outputs(name, cfg, mod, params, data,
                                      mesh).items():
                out[f"{key}/{k}"] = v
            state, metrics = train_on_mesh(name, cfg, mod, tree, data, mesh)
            for k, v in metrics.items():
                out[f"{key}/metrics/{k}"] = v
            for n, t in state["opt"]["m"].items():
                out[f"{key}/mshape/{n}"] = np.array(t.shape)
            ckpt.save(case_dir / f"{mesh.name}__{name}", STEPS, state,
                      mesh=mesh, shardings=P.state_specs(mod, cfg, mesh))
        dist.barrier()
    # MICRO_CASES in N_MICRO micro-batches on 4x1
    for name in MICRO_CASES:
        cfg, mod = port_cfg(name), _port_module(name)
        data, tree = load_case(case_dir, name)
        state, metrics = train_on_mesh(name, cfg, mod, tree, data,
                                       meshes[(4, 1)], N_MICRO)
        for k, v in metrics.items():
            out[f"micro/{name}/metrics/{k}"] = v
        ckpt.save(case_dir / f"micro_4x1__{name}", STEPS, state,
                  mesh=meshes[(4, 1)],
                  shardings=P.state_specs(mod, cfg, meshes[(4, 1)]))

    def fresh(name, mesh):
        cfg, mod = port_cfg(name), _port_module(name)
        state = ts.init_state(mod.from_arrays(
            cfg, load_case(case_dir, name)[1], "cpu", mesh=mesh))
        return mod, cfg, state

    # the 2x2 states of MOVE_CASES onto 4x1
    for name in MOVE_CASES:
        mod, cfg, state = fresh(name, meshes[(4, 1)])
        specs = P.state_specs(mod, cfg, meshes[(4, 1)])
        ckpt.restore(case_dir / f"2x2__{name}", STEPS, state,
                     mesh=meshes[(4, 1)], shardings=specs)
        ckpt.save(case_dir / f"moved_4x1__{name}", STEPS, state,
                  mesh=meshes[(4, 1)], shardings=specs)
    # a leaf's bytes flipped: every rank's restore raises
    bad = case_dir / "corrupt"
    if rank == 0:
        shutil.copytree(case_dir / f"2x2__{CORRUPT[0]}", bad)
        leaf = bad / f"step_{STEPS:08d}" / CORRUPT[1]
        raw = bytearray(leaf.read_bytes())
        raw[-1] ^= 0xFF
        leaf.write_bytes(bytes(raw))
    dist.barrier()
    mod, cfg, state = fresh(CORRUPT[0], meshes[(2, 2)])
    try:
        ckpt.restore(bad, STEPS, state, mesh=meshes[(2, 2)],
                     shardings=P.state_specs(mod, cfg, meshes[(2, 2)]))
        out["corrupt_raised"] = np.array("")
    except IOError as e:
        out["corrupt_raised"] = np.array(str(e))
    # the reference's checkpoint of REF_CKPT onto 2x2
    wait_for(case_dir / "ref_ckpt.done")
    mod, cfg, state = fresh(REF_CKPT, meshes[(2, 2)])
    specs = P.state_specs(mod, cfg, meshes[(2, 2)])
    ckpt.restore(case_dir / "ref_ckpt", STEPS, state, mesh=meshes[(2, 2)],
                 shardings=specs)
    ckpt.save(case_dir / "ref_on_2x2", STEPS, state, mesh=meshes[(2, 2)],
              shardings=specs)
    np.savez(case_dir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _jbatch(batch: dict) -> dict:
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch.items()}


def reference_steps(name: str, params, data, n_micro: int = 1):
    """The reference's unsharded steps of the case's batches: the state
    after them ("params/...", "m/..."), each step's metrics
    ("metrics/<key>"), each leaf's gradient floor over the steps
    ("floor/...": the elements whose gradient lies below 1e-4 of the
    leaf's largest, read off the first moments as
    ``tests/torch_mesh_train_worker.py`` reads them) and the summed
    learning rate ("lr_sum"); with one micro-batch, the serve outputs of
    the initial weights ("serve", "retrieval")."""
    import jax
    from repro.configs.registry import get_arch
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    cfg = jax_cfg(name)
    mod = get_arch(CASES[name]).module
    opt = jopt.AdamWConfig(**OPT)
    out = {}
    if n_micro == 1:
        serve = _jbatch(serve_batch(name, data) if not is_gat(name)
                        else batches(data)[0])
        out["serve"] = np.asarray(jax.jit(functools.partial(
            mod.forward, cfg))(params, serve))
    if n_micro == 1 and not is_gat(name):
        out["retrieval"] = np.asarray(jax.jit(functools.partial(
            mod.retrieval_score, cfg))(params, _jbatch(
                retrieval_batch(name, data))))
    step = jax.jit(jts.make_train_step(functools.partial(mod.loss_fn, cfg),
                                       opt, n_micro=n_micro))
    state, seq, floor = jts.init_state(params), [], None
    m_prev = {k: 0.0 for k in flat(params)}
    for b in batches(data):
        state, m = step(state, _jbatch(b))
        seq.append({k: float(v) for k, v in m.items()})
        m_now = flat(state["opt"]["m"])
        g = {k: np.abs(m_now[k] - opt.b1 * m_prev[k]) for k in m_now}
        f = {k: a < 1e-4 * a.max() for k, a in g.items()}
        floor = f if floor is None else {k: floor[k] | f[k] for k in f}
        m_prev = m_now
    out |= {f"params/{k}": v for k, v in flat(state["params"]).items()}
    out |= {f"m/{k}": v for k, v in flat(state["opt"]["m"]).items()}
    out |= {f"floor/{k}": v for k, v in floor.items()}
    out |= {f"metrics/{k}": np.array([m[k] for m in seq]) for k in seq[0]}
    out["lr_sum"] = np.array(sum(m["lr"] for m in seq))
    return out, state


def run_unsharded(case_dir: Path, names: list[str]) -> None:
    os.environ["XLA_FLAGS"] = XLA_ONE_THREAD
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import jax
    import jax.numpy as jnp
    from repro.train import checkpoint as jckpt
    order = list(CASES)
    for name in names:
        draw_case(case_dir, order.index(name), name)
    for name in names:
        data, _ = load_case(case_dir, name)
        from repro.configs.registry import get_arch
        params = jax.jit(functools.partial(
            get_arch(CASES[name]).module.init_params, jax_cfg(name)))(
                jax.random.key(order.index(name)))
        params = jax.tree.map(jnp.asarray, params)
        out, state = reference_steps(name, params, data)
        np.savez(case_dir / f"{name}__ref.npz", **out)
        if name in MICRO_CASES:
            np.savez(case_dir / f"{name}__ref_micro.npz", **reference_steps(
                name, params, data, N_MICRO)[0])
        if name == REF_CKPT:
            jckpt.save(case_dir / "ref_ckpt", STEPS, state)
            (case_dir / "ref_ckpt.done").touch()


def run_reference(case_dir: Path, name: str) -> None:
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count=4 {XLA_ONE_THREAD}"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import jax
    from jax.sharding import AxisType, NamedSharding, PartitionSpec

    from repro import sharding as jsh
    from repro.configs.registry import get_arch
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts

    cfg = jax_cfg(name)
    mod = get_arch(CASES[name]).module
    data, _ = load_case(case_dir, name)
    params = jax.jit(functools.partial(mod.init_params, cfg))(
        jax.random.key(list(CASES).index(name)))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    prof = jsh.PROFILES["tp"](mesh)
    p_sh = jsh.spec_tree(params, mod.param_logical(cfg), mesh, prof)
    m_sh = jsh.zero1_sharding_tree(params, p_sh, mesh)
    rep = NamedSharding(mesh, PartitionSpec())
    s_sh = {"params": p_sh, "opt": {"m": m_sh, "v": m_sh, "step": rep}}
    b0 = batches(data)[0]
    b_sh = {k: jsh.named_sharding(mesh, (jsh.BATCH,) + (None,) * (
        v.ndim - 1), v.shape, prof) for k, v in b0.items()}
    step = jax.jit(jts.make_train_step(
        functools.partial(mod.loss_fn, cfg, mesh=mesh),
        jopt.AdamWConfig(**OPT)),
        in_shardings=(s_sh, b_sh), out_shardings=(s_sh, rep))
    seq = []
    with mesh:
        state = jax.device_put(jts.init_state(params), s_sh)
        for b in batches(data):
            state, m = step(state, _jbatch(b))
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
