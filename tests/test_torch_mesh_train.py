"""LM training on a mesh of four gloo ranks on the CPU, against the JAX
package (``tests/torch_mesh_train_worker.py`` holds the ranks).

The reduced configs of the five LMs in float32, each with its full
config's sharding profile (qwen2 and llama4 ``fsdp``, glm4 ``tp`` with
``seq_parallel``, internlm2 and olmoe ``tp``), the MoE LMs at a capacity
factor of 0.5 (so that tokens are dropped), Llama-4 at 4 layers (a global
layer beside the chunked ones), and qwen2 once more on the flash training
path (``flash_attention_xla``: its plain version on the CPU).  On the
meshes 1x4, 2x2 and 4x1 the port's sharded train step, with remat, takes
two AdamW steps of two micro-batches from the reference's
``init_params`` draw (``lm_from_arrays(..., mesh=)``); its metrics, and
the parameters and first moments gathered from the shards (the
checkpoint it saves on the mesh), match the reference's unsharded
``jax.jit(make_train_step(...))`` on the same batches by
``tests/test_torch_train_lm.py``'s leaf bound and floor rule.  Every
rank's moment shard has the shape the reference's
``zero1_sharding_tree`` gives; qwen2 on 2x2 also matches the reference's
own sharded step on four forced host devices.  Checkpoints move: a 2x2
state restores onto 4x1 and onto one card bit for bit, the reference's
own checkpoint restores onto the port's 2x2 mesh, and a corrupted leaf
raises on every rank.  The ranks are spawned once for the module, on one
intra-op thread each, beside the reference's processes."""
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
from repro.models import transformer_lm as JT
from repro_torch.models import transformer_lm as TT
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts

import torch_mesh_train_worker as W
from test_torch_mesh_lm import _flat, _jcfg

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
#: name -> (arch, overrides of the reduced config)
CASES = {
    "qwen2": ("qwen2-1.5b", {"sharding_profile": "fsdp"}),
    "glm4": ("glm4-9b", {"sharding_profile": "tp", "seq_parallel": True}),
    "internlm2": ("internlm2-1.8b", {"sharding_profile": "tp"}),
    "olmoe": ("olmoe-1b-7b", {"sharding_profile": "tp",
                              "capacity_factor": 0.5}),
    "llama4": ("llama4-scout-17b-a16e", {"sharding_profile": "fsdp",
                                         "capacity_factor": 0.5,
                                         "n_layers": 4}),
    "qwen2 flash": ("qwen2-1.5b", {"sharding_profile": "fsdp",
                                   "attn_impl": "flash"}),
}
#: the case the reference also runs sharded on 2x2
REF_SHARDED = "qwen2"
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
    """One spawn of the four ranks, of two processes that draw the cases'
    inputs and compute the reference's unsharded steps (half the cases
    each; one also writes the reference's checkpoint of REF_CASE for the
    ranks to restore), and of the reference's sharded run; their
    results."""
    case_dir = tmp_path_factory.mktemp("mesh_train")
    cases = [{"name": name, "arch": arch, "overrides": over}
             for name, (arch, over) in CASES.items()]
    (case_dir / "cases.json").write_text(json.dumps(cases))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    worker = [sys.executable,
              str(Path(__file__).with_name("torch_mesh_train_worker.py"))]
    names = list(CASES)
    args = [["rank", str(case_dir), str(r), str(WORLD)]
            for r in range(WORLD)]
    args += [["unsharded", str(case_dir), *names[:3]],
             ["unsharded", str(case_dir), *names[3:]],
             ["reference", str(case_dir), REF_SHARDED]]
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
                    for n in names},
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
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(run, case, mesh_name):
    """Two steps of two micro-batches on the mesh: every rank's metrics
    within rtol 1e-4 of the reference's unsharded step's, and the state
    gathered from the shards held to its state."""
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
@pytest.mark.parametrize("case", list(CASES))
def test_moment_shards_are_the_reference_zero1_specs(run, case, mesh_name):
    """Every rank's first-moment shard of every leaf (its layers stacked)
    has the shape of the reference's ``zero1_sharding_tree`` at the rank's
    coordinates; with the layer axis cut, a rank holds its layers alone."""
    arch, over = CASES[case]
    jcfg = _jcfg(arch, over)
    shape = tuple(int(n) for n in mesh_name.split("x"))
    jm = AbstractMesh(shape, ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2)
    prof = jsh.PROFILES[jcfg.sharding_profile](jm)
    abstract = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.key(0)))
    specs = jsh.pspec_tree(abstract, JT.param_logical(jcfg), jm, prof)
    zero1 = _flat(jax.tree.map(lambda a, s: jsh.zero1_spec(s, a.shape, jm),
                               abstract, specs))
    full = {k: v.shape for k, v in _flat(abstract).items()}
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


def test_matches_the_reference_sharded_step(run):
    """qwen2 (fsdp) on 2x2: the port's metrics and gathered state against
    the reference's own sharded step on four host devices, and that
    against its unsharded step."""
    ref, sharded = run["ref"][REF_SHARDED], run["ref2x2"]
    for key, want in _part(sharded, "metrics/").items():
        np.testing.assert_allclose(ref[f"metrics/{key}"], want, rtol=1e-4)
        np.testing.assert_allclose(
            run["ranks"][0][f"2x2/{REF_SHARDED}/metrics/{key}"], want,
            rtol=1e-4)
    _held_to_reference(_ckpt(run["dir"] / f"2x2__{REF_SHARDED}"), ref,
                       sharded)


def test_a_2x2_state_restores_onto_4x1_bit_for_bit(run):
    """MOVE_CASE's state saved on 2x2 (moments cut along the layers),
    restored onto 4x1 (moments cut along d_model) and saved again: every
    leaf bit-equal."""
    a = _ckpt(run["dir"] / f"2x2__{W.MOVE_CASE}")
    b = _ckpt(run["dir"] / "moved_4x1")
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_a_2x2_state_restores_onto_one_card(run):
    """The same checkpoint restored into a one-card state: every
    parameter and moment bit-equal to the leaves on disk."""
    arch, over = CASES[W.MOVE_CASE]
    cfg = W.port_cfg({"arch": arch, "overrides": over})
    state = ts.init_state(TT.TransformerLM(cfg, "cpu"))
    ckpt.restore(run["dir"] / f"2x2__{W.MOVE_CASE}", W.STEPS, state)
    disk = _ckpt(run["dir"] / f"2x2__{W.MOVE_CASE}")
    tree = TT.lm_to_arrays(cfg, state["params"])
    for k, v in _flat(tree).items():
        assert np.array_equal(v, disk[f"params/{k}"]), k
    for name, t in state["opt"]["m"].items():
        path, stacked = TT._tree_path(name)
        want = disk["opt/m/" + "/".join(path)]
        want = want[int(name.split(".")[1])] if stacked else want
        assert np.array_equal(t.numpy(), want), name
    assert int(state["opt"]["step"]) == W.STEPS


def test_the_reference_checkpoint_restores_onto_the_mesh(run):
    """The reference's ``checkpoint.save`` of REF_CASE's state after its
    steps, restored onto the port's 2x2 mesh and saved from there: every
    leaf bit-equal to the reference's file."""
    a = _ckpt(run["dir"] / "ref_ckpt")
    b = _ckpt(run["dir"] / "ref_on_2x2")
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_a_corrupted_leaf_raises_on_every_rank(run):
    for r, res in enumerate(run["ranks"]):
        assert "corruption in leaf 'params/embed'" in \
            str(res["corrupt_raised"]), r
