"""The dry run per card of a mesh (``launch/dryrun.py::run_cell`` with
``multi_pod=`` or ``mesh=``), on the CPU: qwen2-1.5b x decode_32k and
olmoe-1b-7b x long_500k at 2 layers on the reference's 16x16 and 2x16x16
meshes, shape-only at rank 0's coordinates, the bundle on ``meta``."""
import math

import pytest
import torch

from repro_torch.launch import dryrun, mesh
from repro_torch.launch.steps import WaitsForSlice, build_bundle

from torch_dryrun import KEYS, MEMORY_KEYS

CELLS = [("qwen2-1.5b", "decode_32k"), ("olmoe-1b-7b", "long_500k")]
OVER = {"n_layers": "2"}


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
    for arch_id, shape in (("qwen2-1.5b", "train_4k"),
                           ("dcn-v2", "serve_p99")):
        with pytest.raises(WaitsForSlice, match="slice"):
            build_bundle(arch_id, shape, device="meta", mesh=m)
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
