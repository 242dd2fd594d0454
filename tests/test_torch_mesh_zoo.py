"""The model zoo on a mesh of four gloo ranks on the CPU, against the JAX
package (``tests/torch_mesh_zoo_worker.py`` holds the ranks).

The reduced configs of DCN-v2, AutoInt, DIEN, MIND and GAT (node-level,
and with a molecule-style mean readout over packed graphs), from the
reference's ``init_params`` draw carried across by ``from_arrays(...,
mesh=)``, on the meshes 1x4, 2x2 and 4x1 under the ``tp`` profile: the
recsys tables' rows over ``model`` where they divide (AutoInt's 1,950
rows do not divide 4: whole on 1x4), the MLP towers' columns over
``model``, the batch's 16 rows over the data axes (4 a rank on 4x1, so
DIEN's roll of its negatives crosses every shard boundary and MIND's
in-batch softmax spans four shards), a graph's nodes and edges over the
data axes.  Two AdamW steps of the port's sharded train step: its
metrics, and the parameters and first moments gathered from the shards
(the checkpoint it saves on the mesh), match the reference's unsharded
``jax.jit(make_train_step(...))`` on the same batches by
``tests/test_torch_train_lm.py``'s leaf bound and floor rule; the serve
outputs (``forward``) and retrieval scores (64 candidates over
``CANDIDATES``), gathered, match the reference's.  Every rank's moment
shard has the shape of the reference's ``zero1_sharding_tree``.  DIEN
and MIND also step in two micro-batches on 4x1, against the reference's
step of two micro-batches (each rank's share of each micro-batch, not a
split of its own block).  DCN-v2
on 2x2 also matches the reference's own sharded step on four forced host
devices.  Checkpoints move: the 2x2 DCN-v2 and MIND states restore onto
4x1 and onto one card bit for bit, the reference's own DIEN checkpoint
restores onto 2x2, and a corrupted leaf raises on every rank.  The ranks
are spawned once for the module, on one intra-op thread each, beside the
reference's processes."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, AxisType

from repro import sharding as jsh
from repro.configs import registry as jregistry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts

import torch_mesh_zoo_worker as W

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
CASES = list(W.CASES)
#: the case the reference also runs sharded on 2x2
REF_SHARDED = "dcn-v2"
MESH_NAMES = ["1x4", "2x2", "4x1"]


def _close(got, want, what=""):
    """Within 1e-5 + 1e-4 x the largest |want| of the leaf."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=1e-5 + 1e-4 * float(np.abs(want).max()))


def _ckpt(path: Path) -> dict:
    """The leaves of the checkpoint under ``path`` by JAX path."""
    d = path / f"step_{W.STEPS:08d}"
    leaves = json.loads((d / "manifest.json").read_text())["leaves"]
    return {k: np.load(d / m["file"]) for k, m in leaves.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One spawn of the four ranks, of three processes that draw the
    cases' inputs and compute the reference's unsharded steps and outputs
    (two cases each; one also writes the reference's checkpoint of
    REF_CKPT), and of the reference's sharded run; their results."""
    case_dir = tmp_path_factory.mktemp("mesh_zoo")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    worker = [sys.executable,
              str(Path(__file__).with_name("torch_mesh_zoo_worker.py"))]
    args = [["rank", str(case_dir), str(r), str(WORLD)]
            for r in range(WORLD)]
    args += [["unsharded", str(case_dir), *names] for names in (
        ("dcn-v2", "gat"), ("dien", "gat-molecule"), ("autoint", "mind"))]
    args += [["reference", str(case_dir), REF_SHARDED]]
    procs = [subprocess.Popen(worker + a, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in args]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return {"dir": case_dir,
            "ranks": [dict(np.load(case_dir / f"rank{r}.npz"))
                      for r in range(WORLD)],
            "ref": {n: dict(np.load(case_dir / f"{n}__ref.npz"))
                    for n in CASES},
            "ref_micro": {n: dict(np.load(case_dir / f"{n}__ref_micro.npz"))
                          for n in W.MICRO_CASES},
            "ref2x2": dict(np.load(case_dir / f"{REF_SHARDED}__ref2x2.npz"))}


def _part(tree: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in tree.items()
            if k.startswith(prefix)}


def _held_to_reference(got: dict, ref: dict, want: dict):
    """The gathered parameters ``got`` ("params/...", "opt/m/...") held to
    ``want``'s ("params/...", "m/...") within the leaf bound where the
    reference's gradient stood above its floor (else within the summed
    learning rate), and the first moments within the leaf bound."""
    params, lr_sum = _part(want, "params/"), float(ref["lr_sum"])
    assert set(_part(got, "params/")) == set(params)
    for k, w in params.items():
        g, lo = got[f"params/{k}"], ref[f"floor/{k}"]
        _close(g[~lo], w[~lo], k)
        assert np.all(np.abs(g[lo] - w[lo]) <= lr_sum), k
    moments = _part(want, "m/")
    assert set(_part(got, "opt/m/")) == set(moments)
    for k, w in moments.items():
        _close(got[f"opt/m/{k}"], w, f"m {k}")


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_reference(run, case, mesh_name):
    """Two steps on the mesh: every rank's metrics within rtol 1e-4 of the
    reference's unsharded step's, and the state gathered from the shards
    held to its state."""
    ref = run["ref"][case]
    for r, res in enumerate(run["ranks"]):
        for key, want in _part(ref, "metrics/").items():
            np.testing.assert_allclose(
                res[f"{mesh_name}/{case}/metrics/{key}"], want, rtol=1e-4,
                err_msg=f"{key} rank {r}")
    saved = _ckpt(run["dir"] / f"{mesh_name}__{case}")
    assert int(saved["opt/step"]) == W.STEPS
    _held_to_reference(saved, ref, ref)


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", CASES)
def test_serve_outputs_match_reference(run, case, mesh_name):
    """``forward`` (a GAT's logits, of every node or graph) and a recsys
    model's ``retrieval_score`` on the mesh, gathered from the ranks,
    within the leaf bound of the reference's, on every rank."""
    ref = run["ref"][case]
    keys = ["serve"] if W.is_gat(case) else ["serve", "retrieval"]
    for r, res in enumerate(run["ranks"]):
        for k in keys:
            _close(res[f"{mesh_name}/{case}/{k}"], ref[k], f"{k} rank {r}")


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", CASES)
def test_moment_shards_are_the_reference_zero1_specs(run, case, mesh_name):
    """Every rank's first-moment shard of every leaf has the shape of the
    reference's ``zero1_sharding_tree`` of its ``pspec_tree`` under the
    ``tp`` profile."""
    cfg = W.jax_cfg(case)
    mod = jregistry.get_arch(W.CASES[case]).module
    shape = tuple(int(n) for n in mesh_name.split("x"))
    jm = AbstractMesh(shape, ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2)
    abstract = jax.eval_shape(lambda: mod.init_params(cfg,
                                                      jax.random.key(0)))
    specs = jsh.pspec_tree(abstract, mod.param_logical(cfg), jm,
                           jsh.PROFILES["tp"](jm))
    zero1 = W.flat(jax.tree.map(lambda a, s: jsh.zero1_spec(s, a.shape, jm),
                                abstract, specs,
                                is_leaf=lambda x: isinstance(
                                    x, jax.sharding.PartitionSpec)))
    full = {k: v.shape for k, v in W.flat(jax.tree.map(
        lambda a: np.zeros(a.shape, np.int8), abstract)).items()}
    for res in run["ranks"]:
        prefix = f"{mesh_name}/{case}/mshape/"
        got = {k[len(prefix):].replace(".", "/"): tuple(v)
               for k, v in res.items() if k.startswith(prefix)}
        assert set(got) == set(full)
        for key, spec in zero1.items():
            want = []
            for i, n in enumerate(full[key]):
                e = spec[i] if i < len(spec) else None
                for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                    n //= jm.shape[a]
                want.append(n)
            assert got[key] == tuple(want), (key, spec)


@pytest.mark.parametrize("case", W.MICRO_CASES)
def test_micro_batched_step_matches_reference(run, case):
    """Two steps of N_MICRO micro-batches on 4x1 (two rows a rank in
    each): every rank's metrics within rtol 1e-4 of the reference's step
    of N_MICRO micro-batches, and the state gathered from the shards held
    to its state, so that micro-batch i is the global batch's rows
    [i B/n, (i+1) B/n) for DIEN's roll and MIND's in-batch softmax."""
    ref = run["ref_micro"][case]
    for r, res in enumerate(run["ranks"]):
        for key, want in _part(ref, "metrics/").items():
            np.testing.assert_allclose(res[f"micro/{case}/metrics/{key}"],
                                       want, rtol=1e-4,
                                       err_msg=f"{key} rank {r}")
    saved = _ckpt(run["dir"] / f"micro_4x1__{case}")
    assert int(saved["opt/step"]) == W.STEPS
    _held_to_reference(saved, ref, ref)


def test_matches_the_reference_sharded_step(run):
    """DCN-v2 on 2x2 (its table's rows and MLP columns over model): the
    port's metrics and gathered state against the reference's own sharded
    step on four host devices, and that against its unsharded step."""
    ref, sharded = run["ref"][REF_SHARDED], run["ref2x2"]
    for key, want in _part(sharded, "metrics/").items():
        np.testing.assert_allclose(ref[f"metrics/{key}"], want, rtol=1e-4)
        np.testing.assert_allclose(
            run["ranks"][0][f"2x2/{REF_SHARDED}/metrics/{key}"], want,
            rtol=1e-4)
    _held_to_reference(_ckpt(run["dir"] / f"2x2__{REF_SHARDED}"), ref,
                       sharded)


@pytest.mark.parametrize("case", W.MOVE_CASES)
def test_a_2x2_state_restores_onto_4x1_bit_for_bit(run, case):
    """The case's state saved on 2x2 (its table's rows cut over model),
    restored onto 4x1 (the rows whole, the moments cut over data) and
    saved again: every leaf bit-equal."""
    a = _ckpt(run["dir"] / f"2x2__{case}")
    b = _ckpt(run["dir"] / f"moved_4x1__{case}")
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("case", W.MOVE_CASES)
def test_a_2x2_state_restores_onto_one_card(run, case):
    """The same checkpoint restored into a one-card state: every
    parameter and moment bit-equal to the leaves on disk."""
    mod = W._port_module(case)
    cfg = W.port_cfg(case)
    cls = {"dcn-v2": "DCN", "mind": "MIND"}[case]
    state = ts.init_state(getattr(mod, cls)(cfg, "cpu"))
    ckpt.restore(run["dir"] / f"2x2__{case}", W.STEPS, state)
    disk = _ckpt(run["dir"] / f"2x2__{case}")
    for name, p in state["params"].named_parameters():
        path = name.replace(".", "/")
        assert np.array_equal(p.detach().numpy(), disk[f"params/{path}"]), \
            name
        assert np.array_equal(state["opt"]["m"][name].numpy(),
                              disk[f"opt/m/{path}"]), name
    assert int(state["opt"]["step"]) == W.STEPS


def test_the_reference_checkpoint_restores_onto_the_mesh(run):
    """The reference's ``checkpoint.save`` of REF_CKPT's state after its
    steps, restored onto the port's 2x2 mesh (DIEN's two tables' rows and
    MLP columns cut over model) and saved from there: every leaf
    bit-equal to the reference's file."""
    a = _ckpt(run["dir"] / "ref_ckpt")
    b = _ckpt(run["dir"] / "ref_on_2x2")
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_a_corrupted_leaf_raises_on_every_rank(run):
    for r, res in enumerate(run["ranks"]):
        assert "corruption in leaf 'params/table'" in \
            str(res["corrupt_raised"]), r
