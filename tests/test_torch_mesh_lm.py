"""The LM serve steps on a mesh of four gloo ranks on the CPU, against the
JAX package (``tests/torch_mesh_worker.py`` holds the ranks).

The reduced configs of the five LMs in float32, each with its full
config's sharding knobs (qwen2 and llama4 ``fsdp``, glm4 ``tp`` with
``seq_parallel``, internlm2 and olmoe ``tp``), the MoE LMs at a capacity
factor of 0.5 (so that tokens are dropped), olmoe once more at batch 1
(its cache sharded over both axes, as at long_500k), and qwen2 with the
flash path (``attn_impl="pallas"``: the plain version on the CPU; the
reference's Pallas kernel in interpret mode).  The weights are the
reference's ``init_params`` draw, carried across by
``lm_from_arrays(..., mesh=)``.  On the meshes 1x4, 2x2 and 4x1 a
prefill and 3 decode steps run on the port's shards; the gathered logits
equal the reference's unsharded ``prefill``/``decode_step`` on the same
tokens within rtol = atol = 1e-5; every shard has the shape the
reference's spec gives; the MoE layers route and drop as the one-card
layer does; routes pinned by ``expert_idx`` give the one-card pass's
logits; ``init_params(..., mesh=)`` holds slices of the one-card draw;
and one case on 2x2 agrees with the reference's own sharded run on four
forced host devices.  The ranks are spawned once for the
module and run every case."""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro import sharding as jsh
from repro.configs import registry as jregistry
from repro.models import transformer_lm as JT
from repro_torch.models import transformer_lm as TT

import torch_mesh_worker as W

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-5)
#: name -> (arch, overrides of the reduced config, batch, prompt, cache)
CASES = {
    "qwen2": ("qwen2-1.5b", {"sharding_profile": "fsdp"}, 4, 16, 24),
    "glm4": ("glm4-9b", {"sharding_profile": "tp", "seq_parallel": True},
             4, 16, 24),
    "internlm2": ("internlm2-1.8b", {"sharding_profile": "tp"}, 4, 16, 24),
    "olmoe": ("olmoe-1b-7b", {"sharding_profile": "tp",
                              "capacity_factor": 0.5}, 4, 16, 24),
    "olmoe b1": ("olmoe-1b-7b", {"sharding_profile": "tp",
                                 "capacity_factor": 0.5}, 1, 16, 24),
    "llama4": ("llama4-scout-17b-a16e", {"sharding_profile": "fsdp",
                                         "capacity_factor": 0.5}, 4, 16, 24),
    "qwen2 pallas": ("qwen2-1.5b", {"sharding_profile": "fsdp",
                                    "attn_impl": "pallas"}, 2, 32, 36),
}
#: the case the reference also runs sharded on 2x2
REF_SHARDED = "qwen2"
MESH_NAMES = ["1x4", "2x2", "4x1"]


def _jcfg(arch, over):
    cfg = jregistry.get_arch(arch).reduced()[0]
    over = dict(over)
    cf = over.pop("capacity_factor", None)
    if cf is not None:
        over["moe"] = dataclasses.replace(cfg.moe, capacity_factor=cf)
    return dataclasses.replace(cfg, dtype=jnp.float32, remat=False, **over)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's unsharded logits of every case, then one spawn of
    the four ranks (and the reference's sharded run beside them)."""
    case_dir = tmp_path_factory.mktemp("mesh_lm")
    cases, want = [], {}
    for i, (name, (arch, over, B, P, T)) in enumerate(CASES.items()):
        jcfg = _jcfg(arch, over)
        params = JT.init_params(jcfg, jax.random.key(i))
        rng = np.random.default_rng(i)
        toks = rng.integers(0, jcfg.vocab, (B, P), dtype=np.int32)
        nxt = rng.integers(0, jcfg.vocab, (W.DECODE_STEPS, B, 1),
                           dtype=np.int32)
        lg, cache = jax.jit(functools.partial(JT.prefill, jcfg))(
            params, jnp.asarray(toks), JT.init_kv_cache(jcfg, B, T))
        logits = [np.asarray(lg)]
        dec = jax.jit(functools.partial(JT.decode_step, jcfg))
        for j in range(W.DECODE_STEPS):
            lg, cache = dec(params, jnp.asarray(nxt[j]), cache,
                            jnp.int32(P + j))
            logits.append(np.asarray(lg))
        want[name] = np.stack(logits)
        flat = {f"p/{k}": np.asarray(v, np.float32)
                for k, v in _flat(params).items()}
        np.savez(case_dir / f"{name}.npz", tokens=toks, next=nxt, **flat)
        cases.append({"name": name, "arch": arch, "overrides": over,
                      "cache_len": T})
    (case_dir / "cases.json").write_text(json.dumps(cases))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    worker = str(Path(__file__).with_name("torch_mesh_worker.py"))
    procs = [subprocess.Popen([sys.executable, worker, "rank", str(case_dir),
                               str(r), str(WORLD)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, worker, "reference", str(case_dir), REF_SHARDED],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out))
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    ranks = [dict(np.load(case_dir / f"rank{r}.npz")) for r in range(WORLD)]
    ref2x2 = np.load(case_dir / f"{REF_SHARDED}__ref2x2.npz")["logits"]
    return {"want": want, "ranks": ranks, "ref2x2": ref2x2}


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_reference(run, case, mesh_name):
    """A prefill and 3 decode steps on the mesh: each rank's gathered
    logits equal the reference's unsharded ones."""
    for r, res in enumerate(run["ranks"]):
        got = res[f"{mesh_name}/{case}/logits"]
        np.testing.assert_allclose(got, run["want"][case], **TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", list(CASES))
def test_shard_shapes_are_the_reference_specs(run, case, mesh_name):
    """Every parameter's and the cache's shard on every rank has the shape
    the reference's spec gives at the rank's coordinates."""
    arch, over, B, P, T = CASES[case]
    jcfg = _jcfg(arch, over)
    shape = tuple(int(n) for n in mesh_name.split("x"))
    jm = AbstractMesh(shape, ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2)
    prof = jsh.PROFILES[jcfg.sharding_profile](jm)
    abstract = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.key(0)))
    specs = _flat(jsh.pspec_tree(abstract, JT.param_logical(jcfg), jm, prof))
    full = {k: v.shape for k, v in _flat(abstract).items()}
    cache_shape = (jcfg.n_layers, B, T, jcfg.n_kv, jcfg.d_head)
    cache_spec = jsh.resolve_spec(JT.kv_cache_logical()["k"].names,
                                  cache_shape, jm, prof)

    def local(spec, dims):
        out = []
        for i, n in enumerate(dims):
            e = spec[i] if i < len(spec) else None
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                n //= jm.shape[a]
            out.append(n)
        return tuple(out)

    for res in run["ranks"]:
        prefix = f"{mesh_name}/{case}/shape/"
        names = [k[len(prefix):] for k in res if k.startswith(prefix)]
        assert "cache" in names and len(names) > 5
        for name in names:
            got = tuple(res[prefix + name])
            if name == "cache":
                assert got == local(cache_spec, cache_shape)
                continue
            path, stacked = TT._tree_path(name)
            key = "/".join(path)
            want = local(specs[key], full[key])
            assert got == (want[1:] if stacked else want), name


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", ["olmoe", "olmoe b1", "llama4"])
def test_moe_routes_and_drops_as_the_unsharded_layer(run, case, mesh_name):
    """Every MoE layer of every pass, on every rank, picks the experts
    and drops the assignments that the one-card port does on the same
    weights and tokens (a capacity factor of 0.5: drops happen)."""
    arch, over, B, P, T = CASES[case]
    jcfg = _jcfg(arch, over)
    i = list(CASES).index(case)
    params = JT.init_params(jcfg, jax.random.key(i))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    cfg = W.port_cfg({"arch": arch, "overrides": over})
    lm = TT.lm_from_arrays(cfg, tree, "cpu")
    rng = np.random.default_rng(i)
    toks = rng.integers(0, jcfg.vocab, (B, P), dtype=np.int32)
    nxt = rng.integers(0, jcfg.vocab, (W.DECODE_STEPS, B, 1), dtype=np.int32)
    metrics: list = []
    cache = TT.init_kv_cache(cfg, B, T, device="cpu")
    with torch.no_grad():
        TT.prefill(cfg, lm, torch.from_numpy(toks), cache, metrics=metrics)
        for j in range(W.DECODE_STEPS):
            TT.decode_step(cfg, lm, torch.from_numpy(nxt[j]), cache, P + j,
                           metrics=metrics)
    dropped = np.array([int(m["dropped"]) for m in metrics])
    idx = np.concatenate([m["expert_idx"].reshape(-1).numpy()
                          for m in metrics])
    assert dropped.sum() > 0
    for res in run["ranks"]:
        np.testing.assert_array_equal(res[f"{mesh_name}/{case}/dropped"],
                                      dropped)
        np.testing.assert_array_equal(res[f"{mesh_name}/{case}/expert_idx"],
                                      idx)


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", ["olmoe", "olmoe b1", "llama4"])
def test_pinned_routes_match_the_one_card_pass(run, case, mesh_name):
    """A prefill with every MoE layer's routes pinned (``expert_idx``) to
    other experts than the router picks: on the mesh as on one card."""
    for r, res in enumerate(run["ranks"]):
        got, want = res[f"{mesh_name}/{case}/pinned"]
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"rank {r}")
        unpinned = run["want"][case][0]
        assert np.abs(want - unpinned).max() > 1e-3


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", list(CASES))
def test_init_params_on_the_mesh_is_the_one_card_draw(run, case, mesh_name):
    """``init_params(..., mesh=)`` on every rank holds the rank's slice of
    every parameter of the one-card draw from the same seed, bit for
    bit."""
    for r, res in enumerate(run["ranks"]):
        assert list(res[f"{mesh_name}/{case}/init_differs"]) == [], r


def test_matches_the_reference_sharded_run(run):
    """qwen2 (fsdp) on 2x2: the port's shards against the reference's own
    run with its shardings on four host devices."""
    for res in run["ranks"]:
        np.testing.assert_allclose(res[f"2x2/{REF_SHARDED}/logits"],
                                   run["ref2x2"], **TOL)
    np.testing.assert_allclose(run["ref2x2"], run["want"][REF_SHARDED],
                               **TOL)
