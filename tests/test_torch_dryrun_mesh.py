"""The dry run per card of a mesh (``launch/dryrun.py::run_cell`` with
``multi_pod=`` or ``mesh=``), on the CPU: qwen2-1.5b x decode_32k and
olmoe-1b-7b x long_500k at 2 layers on the reference's 16x16 and 2x16x16
meshes, and the five LMs' train_4k at 2 layers on 2x2 and 16x16, each
rank's state against the reference's shard shapes on an
``AbstractMesh``; shape-only at rank 0's coordinates, the bundle on
``meta``."""
import dataclasses
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro import sharding as jsh
from repro.configs import registry as jregistry
from repro.models import transformer_lm as JT
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun, mesh
from repro_torch.launch.steps import WaitsForSlice, build_bundle
from repro_torch.models import transformer_lm as TT
from repro_torch.train import optimizer as opt_lib

from test_torch_mesh_lm import _flat
from torch_dryrun import KEYS, MEMORY_KEYS

CELLS = [("qwen2-1.5b", "decode_32k"), ("olmoe-1b-7b", "long_500k")]
OVER = {"n_layers": "2"}
LMS = ["qwen2-1.5b", "glm4-9b", "internlm2-1.8b", "olmoe-1b-7b",
       "llama4-scout-17b-a16e"]


def shard_bytes(bundle) -> int:
    """The bytes of the rank's shards of the bundle's arguments: every
    parameter, the tokens, the cache and the decode position."""
    params, tokens, cache, pos = bundle.args
    n = sum(p.numel() * p.element_size() for p in params.parameters())
    for t in (tokens, cache["k"], cache["v"], pos):
        n += t.numel() * t.element_size()
    return n


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_per_card(cell, multi_pod):
    arch_id, shape = cell
    rec = dryrun.run_cell(arch_id, shape, multi_pod=multi_pod,
                          overrides=OVER, verbose=False)
    assert KEYS <= rec.keys(), KEYS - rec.keys()
    assert rec["memory"].keys() == MEMORY_KEYS
    assert rec["n_chips"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["collectives"] and rec["collective_bytes_per_chip"] > 0
    assert rec["collectives"].keys() == rec["collective_counts"].keys()
    assert math.isclose(rec["collective_bytes_per_chip"],
                        sum(rec["collectives"].values()))
    assert math.isclose(rec["t_collective"],
                        rec["collective_bytes_per_chip"] / mesh.NVLINK_BW)
    assert math.isclose(rec["useful_flops_ratio"], rec["model_flops"] / (
        rec["flops_per_chip"] * rec["n_chips"]))
    m = mesh.make_production_mesh(multi_pod=multi_pod)
    b = build_bundle(arch_id, shape, device="meta", mesh=m, overrides=OVER)
    assert rec["memory"]["argument_bytes"] == shard_bytes(b)
    assert rec["fits"] == (rec["bytes_per_device"] <= mesh.HBM_BYTES)
    # the shards of the cache: batch over the data axes, sequence over
    # what they leave free
    cache_spec = b.out_shardings[1]["k"]
    assert b.args[2]["k"].shape[2] * math.prod(
        m.shape[a] for a in (cache_spec[2] if isinstance(cache_spec[2],
                                                         tuple)
                             else (cache_spec[2],))) == \
        b.args[2]["shape"][2]


def test_bundles_on_a_mesh_carry_the_reference_shardings():
    m = mesh.Mesh((2, 2), ("data", "model"))
    b = build_bundle("qwen2-1.5b", "decode_32k", device="meta", mesh=m,
                     overrides=OVER)
    params_sh, tok_sh, cache_sh, pos_sh = b.in_shardings
    assert tok_sh == ("data", None) and pos_sh == ()
    assert cache_sh["k"] == (None, "data", "model", None, None)
    assert params_sh["embed"] == ("model", "data")
    assert b.out_shardings[0] == ("data", "model")
    assert tuple(b.args[1].shape) == (64, 1)
    assert tuple(b.args[2]["k"].shape) == (2, 64, 16384, 2, 128)
    assert build_bundle("qwen2-1.5b", "decode_32k", device="meta",
                        overrides=OVER).in_shardings is None
    with pytest.raises(WaitsForSlice, match="slice"):
        build_bundle("dcn-v2", "serve_p99", device="meta", mesh=m)
    with pytest.raises(ValueError, match="shape-only"):
        build_bundle("qwen2-1.5b", "decode_32k", device="cpu", mesh=m,
                     overrides=OVER)
    # a 1x1 mesh is one card: the zoo's bundles build as without a mesh
    one = build_bundle("dcn-v2", "serve_p99", device="meta",
                       mesh=mesh.make_host_mesh())
    assert one.in_shardings is None and torch.is_tensor(one.args[1]["cat"])


def test_main_prices_the_production_meshes(tmp_path, capsys):
    dryrun.main(["--arch", "olmoe-1b-7b", "--shape", "long_500k",
                 "--both-meshes", "--override", "n_layers=2", "--out",
                 str(tmp_path)])
    for tag in ("sp", "mp"):
        rec = (tmp_path / f"olmoe-1b-7b__long_500k__{tag}.json").read_text()
        assert '"collectives": {' in rec and '"all-reduce"' in rec
    dryrun.main(["--arch", "dcn-v2", "--shape", "serve_p99", "--multi-pod",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "SKIPPED dcn-v2__serve_p99__mp" in out and "DRY-RUN PASS" in out


@pytest.mark.parametrize("S,T,chunk", [(7, 7, 0), (7, 9, 0), (9, 7, 3),
                                       (16, 16, 4), (5, 5, 8)])
def test_flash_is_priced_by_its_formula(S, T, chunk):
    """Under the op counter the flash kernel's entry charges 4 x D flops a
    visible (query, key) pair and head and its inputs and output once, and
    runs nothing (so a dry run with ``attn_impl="pallas"`` prices the
    kernel, not its plain version)."""
    from repro_torch.analysis import op_cost
    from repro_torch.kernels.flash_attention import ops
    q_pos = torch.arange(S)[:, None]
    k_pos = torch.arange(T)[None, :]
    ok = k_pos <= q_pos
    if chunk:
        ok &= (k_pos // chunk) == (q_pos // chunk)
    assert ops.visible_pairs(S, T, True, chunk) == int(ok.sum())
    q = torch.empty(2, S, 4, 8, device="meta")
    k = torch.empty(2, T, 2, 8, device="meta")
    got = op_cost.analyze(
        lambda: ops.flash_attention(q, k, k, causal=True, chunk=chunk))
    assert got["flops_per_chip"] == 4 * 2 * 4 * 8 * int(ok.sum())
    assert got["bytes_per_chip"] == 4 * (2 * q.numel() + 2 * k.numel())


def _reference_shards(arch_id: str, shape) -> dict:
    """The reference's train_4k state at 2 layers on an ``AbstractMesh``
    of ``shape``: each leaf's (parameter shard shape, moment shard shape,
    its dtype's bytes) by JAX path."""
    cfg = dataclasses.replace(jregistry.get_arch(arch_id).model_cfg(
        "train_4k"), n_layers=2)
    jm = AbstractMesh(shape, ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2)
    prof = jsh.PROFILES[cfg.sharding_profile](jm)
    abstract = jax.eval_shape(lambda: JT.init_params(cfg, jax.random.key(0)))
    specs = jsh.pspec_tree(abstract, JT.param_logical(cfg), jm, prof)

    def local(spec, dims):
        out = []
        for i, n in enumerate(dims):
            e = spec[i] if i < len(spec) else None
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                n //= jm.shape[a]
            out.append(n)
        return tuple(out)

    return {k: (local(s, a.shape), local(jsh.zero1_spec(s, a.shape, jm),
                                         a.shape), a.dtype.itemsize)
            for (k, a), s in zip(_flat(abstract).items(),
                                 _flat(specs).values())}


@pytest.mark.parametrize("shape", [(2, 2), (16, 16)])
@pytest.mark.parametrize("arch_id", LMS)
def test_train_4k_per_card(arch_id, shape):
    """The LM's train_4k at 2 layers builds on ``meta`` on the mesh and is
    priced per card: each parameter's and moment's shard, its layers
    stacked, has the reference's shard shape, leaf for leaf; the
    argument bytes are their sum with the step and the rank's rows of the
    batch; and the record lists the ZeRO-1 reduce-scatter among its
    collectives."""
    m = mesh.Mesh(shape, ("data", "model"))
    rec = dryrun.run_cell(arch_id, "train_4k", mesh=m, overrides=OVER,
                          verbose=False)
    b = build_bundle(arch_id, "train_4k", device="meta", mesh=m,
                     overrides=OVER)
    state, batch = b.args
    cfg = dataclasses.replace(get_arch(arch_id).model_cfg("train_4k"),
                              n_layers=2)
    assert b.in_shardings[0] == TT.state_specs(cfg, m)
    layout = opt_lib.mesh_layout(state["params"])
    params: dict = {}
    moments: dict = {}
    for name, p in state["params"].named_parameters():
        key = layout[name].key.replace(".", "/")
        params.setdefault(key, []).append(p)
        if name in state["opt"]["m"]:
            moments.setdefault(key, []).append(state["opt"]["m"][name])

    def stacked(ts, key):
        shape = tuple(ts[0].shape)
        return (len(ts), *shape) if key.startswith("layers/") else shape

    want = _reference_shards(arch_id, shape)
    assert set(params) == set(moments) == set(want)
    n = 0
    for key, (pshape, mshape, itemsize) in want.items():
        assert stacked(params[key], key) == pshape, key
        assert stacked(moments[key], key) == mshape, key
        assert params[key][0].element_size() == itemsize, key
        n += math.prod(pshape) * itemsize + 2 * 4 * math.prod(mshape)
    n += 4 + sum(t.numel() * t.element_size() for t in batch.values()
                 if torch.is_tensor(t))
    assert rec["memory"]["argument_bytes"] == n
    assert batch["tokens"].shape[0] * math.prod(
        m.shape[a] for a in ("data",)) == batch["rows"]
    assert "reduce-scatter" in rec["collectives"]
