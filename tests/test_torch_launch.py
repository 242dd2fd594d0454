"""The launch layer of the port against the JAX package on the CPU:
``launch/steps.py``'s bundles on all 40 (arch x shape) cells, runnable
bundles through the reference's jitted steps, ``_pad_graph``,
``analysis/op_cost.py::analyze`` against ``hlo_cost.analyze``, the
overrides, the card's constants and the pipeline dry run (the 40 cells'
dry runs are ``tests/test_torch_dryrun_*.py``).

The reference's bundles are built on ``make_host_mesh()``; its steps run
jitted on an Auto-axis 1x1 mesh that the test builds (jax 0.9.0's default
Explicit axes refuse the steps' sharding constraints: ROADMAP §3).
Weights are the reference's draws carried across, inputs numpy arrays fed
to both sides; values agree within ``tests/test_torch_zoo.py``'s leaf
bound (atol 1e-5 + rtol 1e-4 of the leaf's largest |value|)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.analysis import hlo_cost
from repro.configs import registry as jregistry
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import sampler as jsampler
from repro.models import transformer_lm as JT
from repro.train import train_step as jts
from repro_torch.analysis import op_cost
from repro_torch.configs import registry as tregistry
from repro_torch.launch import dryrun, mesh, pipeline_dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.models import param_tree
from repro_torch.models import transformer_lm as TT
from repro_torch.train import checkpoint as ckpt

def auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def ref_leaves(tree) -> dict:
    """path -> (shape, dtype name) of a reference tree of arrays or
    ShapeDtypeStructs, paths as the reference's checkpoints name them."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                       for p in path)
        out[key] = (tuple(leaf.shape), dtype_name(leaf.dtype))
    return out


def port_leaves(tree) -> dict:
    """The same of a port tree, flattened by the checkpoints' declared
    layout (an LM's layers stacked on L)."""
    out = {}
    for key, entries in ckpt._keyed(tree).items():
        leaf = entries[0][1]
        shape = tuple(leaf.shape)
        if entries[0][0] is not None:
            shape = (len(entries), *shape)
        out[key] = (shape, dtype_name(leaf.dtype))
    return out


def bytes_by_dtype(leaves: dict) -> dict:
    out = {}
    for shape, dt in leaves.values():
        size = {"bfloat16": 2, "float32": 4, "int32": 4, "bool": 1}[dt]
        out[dt] = out.get(dt, 0) + size * int(np.prod(shape, dtype=np.int64))
    return out


def assert_leaf_close(got, want, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = 1e-5 + 1e-4 * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound, err_msg=what)


# ---------------------------------------------------------------------------
# build_bundle on all 40 cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", jregistry.all_arch_ids())
def test_bundles_match_reference(arch_id):
    """Every shape of the arch on ``meta``: the step's name, the inputs'
    names, shapes and dtypes, the state's leaves (count and bytes by
    dtype, in the reference's tree paths), the donated arguments and the
    model FLOPs."""
    hmesh = jmesh.make_host_mesh()
    for shape in jregistry.get_arch(arch_id).shapes:
        want = jsteps.build_bundle(arch_id, shape, hmesh)
        got = tsteps.build_bundle(arch_id, shape, device="meta")
        assert got.name == want.name, shape
        assert got.donate_argnums == want.donate_argnums, shape
        np.testing.assert_allclose(got.model_flops_per_step,
                                   want.model_flops_per_step, rtol=1e-12)
        assert len(got.args) == len(want.args), shape
        ws, gs = ref_leaves(want.args[0]), port_leaves(got.args[0])
        assert len(gs) == len(ws), (shape, set(gs) ^ set(ws))
        assert bytes_by_dtype(gs) == bytes_by_dtype(ws), shape
        assert gs == ws, shape
        for i, (g, w) in enumerate(zip(got.args[1:], want.args[1:]), 1):
            assert port_leaves(g) == ref_leaves(w), (shape, i)
        for t in op_cost._all_tensors(got.args):
            assert t.device.type == "meta" or t.dim() == 0, shape


def test_registry_carries_train_microbatches():
    for arch_id in jregistry.all_arch_ids():
        assert tregistry.get_arch(arch_id).train_microbatches == \
            jregistry.get_arch(arch_id).train_microbatches, arch_id


def test_overrides_apply_and_refuse_what_one_card_lacks():
    b = tsteps.build_bundle("olmoe-1b-7b", "long_500k", device="meta",
                            overrides={"n_layers": "2", "moe.top_k": "2",
                                       "attn_impl": "pallas"})
    assert len(b.args[0].layers) == 2
    arch = tsteps._apply_overrides(
        tregistry.get_arch("olmoe-1b-7b"),
        {"moe.top_k": "2", "remat": "false", "train_microbatches": "2"})
    cfg = arch.model_cfg("train_4k")
    assert cfg.moe.top_k == 2 and cfg.remat is False
    assert arch.train_microbatches == 2
    # the mesh knobs apply as the reference's do
    mesh_knobs = tsteps._apply_overrides(
        tregistry.get_arch("olmoe-1b-7b"),
        {"sharding_profile": "fsdp", "seq_parallel": "true"})
    cfg = mesh_knobs.model_cfg("decode_32k")
    assert (cfg.sharding_profile, cfg.seq_parallel) == ("fsdp", True)
    for bad in ({"no_such_field": "fsdp"}, {"moe.no_such_field": "1"}):
        with pytest.raises(KeyError, match="override"):
            tsteps.build_bundle("olmoe-1b-7b", "decode_32k", device="meta",
                                overrides=bad)
    with pytest.raises(KeyError, match="no mixture of experts"):
        tsteps.build_bundle("qwen2-1.5b", "decode_32k", device="meta",
                            overrides={"moe.top_k": "2"})
    with pytest.raises(KeyError, match="has no shape"):
        tsteps.build_bundle("qwen2-1.5b", "molecule", device="meta")


def test_bundle_takes_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsteps.build_bundle("dcn-v2", "serve_p99")


# ---------------------------------------------------------------------------
# bundles that run: the port's fn against the reference's jitted fn
# ---------------------------------------------------------------------------


def _run_ref(bundle, *args):
    mesh = auto_mesh()
    with mesh:
        return jax.jit(bundle.fn)(*args)


def test_gat_molecule_train_step_matches_reference():
    """gat-cora x molecule at its published size: one train step (padded
    to 128 inside) from the reference's draw."""
    want_b = jsteps.build_bundle("gat-cora", "molecule", auto_mesh())
    got_b = tsteps.build_bundle("gat-cora", "molecule", device="cpu")
    cell = jregistry.get_arch("gat-cora").shapes["molecule"]
    cfg = jregistry.get_arch("gat-cora").model_cfg("molecule")
    params = jregistry.get_arch("gat-cora").module.init_params(
        cfg, jax.random.key(0))
    host = jsampler.pack_molecule_batch(
        np.random.default_rng(3), cell["n_graphs"], cell["nodes_per_graph"],
        cell["edges_per_graph"], cell["d_feat"], cell["n_classes"])
    jstate, jm = _run_ref(want_b, jts.init_state(params),
                          {k: jnp.asarray(v) for k, v in host.items()})
    state, batch = got_b.args
    param_tree.load_arrays(state["params"], jax.tree.map(np.asarray, params))
    assert batch.keys() == host.keys()
    state, m = got_b.fn(state, {k: torch.from_numpy(v)
                                for k, v in host.items()})
    assert_leaf_close(m["ce"], jm["ce"], "ce")
    want = {".".join(str(getattr(p, "key", getattr(p, "idx", None)))
                     for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(
                jstate["params"])[0]}
    for n, p in state["params"].named_parameters():
        assert_leaf_close(p, want[n], n)


def test_reduced_recsys_train_step_matches_reference():
    """DCN-v2 x train_batch (65,536 rows) with the reduced config's
    vocabularies and tower through ``overrides``: one train step."""
    over = {"vocabs": (50,) * 26, "mlp": (64, 64, 32)}
    want_b = jsteps.build_bundle("dcn-v2", "train_batch", auto_mesh(),
                                 overrides=over)
    got_b = tsteps.build_bundle("dcn-v2", "train_batch", device="cpu",
                                overrides=over)
    ja = jsteps._apply_overrides(jregistry.get_arch("dcn-v2"), over)
    params = ja.module.init_params(ja.model_cfg("train_batch"),
                                   jax.random.key(1))
    rng = np.random.default_rng(5)
    B = 65536
    host = {"dense": rng.standard_normal((B, 13), dtype=np.float32),
            "cat": rng.integers(0, 50, (B, 26), dtype=np.int32),
            "label": rng.integers(0, 2, B, dtype=np.int32)}
    jstate, jm = _run_ref(want_b, jts.init_state(params),
                          {k: jnp.asarray(v) for k, v in host.items()})
    state, batch = got_b.args
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == \
        {k: (v.shape, torch.from_numpy(v).dtype) for k, v in host.items()}
    assert int(batch["cat"].max()) < 50 and int(batch["cat"].min()) >= 0
    param_tree.load_arrays(state["params"], jax.tree.map(np.asarray, params))
    state, m = got_b.fn(state, {k: torch.from_numpy(v)
                                for k, v in host.items()})
    assert m.keys() == jm.keys()
    for k in m:
        assert_leaf_close(m[k], jm[k], k)
    want = {".".join(str(getattr(p, "key", getattr(p, "idx", None)))
                     for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(
                jstate["params"])[0]}
    for n, p in state["params"].named_parameters():
        assert_leaf_close(p, want[n], n)


def test_reduced_lm_decode_matches_reference():
    """qwen2-1.5b x long_500k (one token against a 524,288-slot cache) at
    the reduced config's widths in float32 through ``overrides``: logits
    and the cache's written slot, updated in place."""
    small = dict(n_layers=2, d_model=64, n_q=4, n_kv=2, d_head=16,
                 d_ff=128, vocab=512)
    want_b = jsteps.build_bundle("qwen2-1.5b", "long_500k", auto_mesh(),
                                 overrides={**small, "dtype": jnp.float32})
    got_b = tsteps.build_bundle("qwen2-1.5b", "long_500k", device="cpu",
                                overrides={**small, "dtype": torch.float32})
    jover, tover = {**small, "dtype": jnp.float32}, \
        {**small, "dtype": torch.float32}
    jcfg = jsteps._apply_overrides(jregistry.get_arch("qwen2-1.5b"),
                                   jover).model_cfg("long_500k")
    tcfg = tsteps._apply_overrides(tregistry.get_arch("qwen2-1.5b"),
                                   tover).model_cfg("long_500k")
    params = JT.init_params(jcfg, jax.random.key(0))
    _, tokens, cache, pos = got_b.args
    T = cache["k"].shape[2]
    assert int(pos) == T - 1 and pos.dtype == torch.int32
    tok = np.random.default_rng(2).integers(0, 512, (1, 1), dtype=np.int32)
    jlog, jcache = _run_ref(
        want_b, params, jnp.asarray(tok),
        {k: jnp.zeros(v.shape, jnp.float32) for k, v in cache.items()},
        jnp.int32(T - 1))
    lm = TT.lm_from_arrays(tcfg, jax.tree.map(
        lambda a: np.asarray(a, np.float32), params), "cpu")
    k_before = cache["k"]
    logits, out = got_b.fn(lm, torch.from_numpy(tok), cache, pos)
    assert out["k"] is k_before                     # in place
    assert_leaf_close(logits, jlog, "logits")
    assert_leaf_close(out["v"][:, :, T - 1],
                      np.asarray(jcache["v"])[:, :, T - 1], "v")
    # k is rotated by RoPE at position 524,287: fp32 holds angles near it
    # only to 2^-5 rad, and torch and XLA reduce sin/cos arguments of
    # that size differently, so the slot agrees within that rounding of
    # its angles (the logits above agree within the leaf bound)
    want_k = np.asarray(jcache["k"])[:, :, T - 1]
    np.testing.assert_allclose(out["k"][:, :, T - 1].numpy(), want_k,
                               rtol=0, atol=np.abs(want_k).max() * 2.0 ** -5)
    for k in ("k", "v"):
        assert not bool(out[k][:, :, :T - 1].any())



# ---------------------------------------------------------------------------
# _pad_graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", ["node", "graph"])
def test_pad_graph_matches_reference(level):
    rng = np.random.default_rng(11)
    if level == "graph":
        host = jsampler.pack_molecule_batch(rng, 5, 7, 9, 3, 2)
    else:
        host = {"x": rng.standard_normal((50, 3), dtype=np.float32),
                "src": rng.integers(0, 50, 77, dtype=np.int32),
                "dst": rng.integers(0, 50, 77, dtype=np.int32),
                "labels": rng.integers(0, 4, 50, dtype=np.int32),
                "label_mask": rng.random(50) < 0.7}
    want = jsteps._pad_graph({k: jnp.asarray(v) for k, v in host.items()},
                             16)
    got = tsteps._pad_graph({k: torch.from_numpy(np.asarray(v))
                             for k, v in host.items()}, 16)
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# ---------------------------------------------------------------------------
# analyze against hlo_cost.analyze
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", [("dcn-v2", "train_batch", None),
                                  ("qwen2-1.5b", "train_4k",
                                   {"n_layers": "1"}),
                                  ("gat-cora", "molecule", None)])
def test_analyze_flops_near_reference_hlo(cell):
    """The op counter's flops of the meta bundle within 25 % of the
    reference's HLO count of its compiled bundle (gat-cora x molecule is
    printed only: elementwise counts dominate it)."""
    arch_id, shape, over = cell
    b = jsteps.build_bundle(arch_id, shape, auto_mesh(), overrides=over)
    with auto_mesh():
        compiled = jax.jit(
            b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings,
            donate_argnums=b.donate_argnums).lower(*b.args).compile()
    want = hlo_cost.analyze(compiled.as_text())["flops_per_chip"]
    tb = tsteps.build_bundle(arch_id, shape, device="meta", overrides=over)
    got = op_cost.analyze(tb.fn, *tb.args)
    ratio = got["flops_per_chip"] / want
    print(f"{arch_id} x {shape} {over or ''}: op counter "
          f"{got['flops_per_chip']:.4g}, reference HLO {want:.4g}, ratio "
          f"{ratio:.4f}")
    assert got["collective_bytes_per_chip"] == 0.0
    assert got["collectives"] == got["collective_counts"] == {}
    if arch_id != "gat-cora":
        assert 0.75 <= ratio <= 1.25, ratio


def test_analyze_memory_counts_each_storage_once():
    """Views share their storage; an op's result dies with its last
    tensor, autograd's saved ones included; the state updated in place is
    aliased."""
    w = torch.empty((256, 256), device="meta", requires_grad=True)
    x = torch.empty((64, 256), device="meta")

    def fn(w, x):
        h = (x @ w).exp()                   # exp saves its result
        v = h.view(-1)[:10]                 # a view: no new bytes
        g, = torch.autograd.grad(h.sum() + v.sum(), w)
        return g

    out = op_cost.analyze(fn, w, x)
    mem = out["memory"]
    assert mem["argument_bytes"] == 4 * (256 * 256 + 64 * 256)
    assert mem["output_bytes"] == 4 * 256 * 256
    assert mem["alias_bytes"] == 0
    # live at once at most: x @ w, its exp, the backward's grad of h and
    # the result, besides the arguments and a few scalars
    assert mem["peak_bytes"] <= mem["argument_bytes"] + \
        4 * (3 * 64 * 256 + 256 * 256) + 4096
    assert mem["peak_bytes"] == mem["argument_bytes"] + \
        mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
    st = {"w": torch.zeros(8, device="meta")}
    inplace = op_cost.analyze(lambda s: {"w": s["w"].add_(1.0)}, st)
    assert inplace["memory"]["alias_bytes"] == 32
    assert inplace["memory"]["temp_bytes"] == 0


def test_analyze_prices_log_sigmoid_as_the_card_allocates():
    """``log_sigmoid_forward`` returns a buffer as large as its input on
    the CPU and on ``meta`` and an empty one on the card: the memory count
    follows its output alone, so DIEN's aux loss is priced as the card
    holds it."""
    x = torch.empty(1000, device="meta", requires_grad=True)
    soft = op_cost.analyze(lambda x: torch.nn.functional.logsigmoid(x),
                           x)["memory"]
    sig = op_cost.analyze(lambda x: torch.sigmoid(x), x)["memory"]
    assert soft == sig and soft["output_bytes"] == 4000


# ---------------------------------------------------------------------------
# the card's constants, the dry run's driver and the pipeline dry run
# ---------------------------------------------------------------------------


def test_card_constants():
    assert mesh.CARD == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert mesh.peak_flops(torch.bfloat16) == mesh.PEAK_FLOPS_BF16 == 989e12
    assert mesh.peak_flops(torch.float32) == mesh.PEAK_FLOPS_FP32 == 67e12
    assert mesh.HBM_BW == 3.35e12
    assert mesh.memory_bytes() == mesh.HBM_BYTES       # no card here


def test_dryrun_main_writes_records_and_refuses_meshes(tmp_path, capsys):
    dryrun.main(["--arch", "gat-cora", "--shape", "molecule", "--out",
                 str(tmp_path), "--tag", "t"])
    rec = (tmp_path / "gat-cora__molecule__1card__t.json").read_text()
    assert '"fits": true' in rec and '"n_chips": 1' in rec
    assert "DRY-RUN PASS" in capsys.readouterr().out
    # the production meshes price per card (tests/test_torch_dryrun_mesh.py)
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k",
                 "--multi-pod", "--override", "n_layers=1", "--out",
                 str(tmp_path)])
    rec = (tmp_path / "qwen2-1.5b__long_500k__mp.json").read_text()
    assert '"n_chips": 512' in rec
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                     "--override", "no_such_field=true", "--out",
                     str(tmp_path)])
    assert e.value.code == 1
    assert "FAILED qwen2-1.5b__decode_32k__1card" in capsys.readouterr().out


def test_pipeline_dryrun_does_not_fit_one_card():
    """The ClueWeb09-scale fat pipeline at the reference's descriptors:
    priced on ``meta``, each gathered int32 array 274.9 GB and the dense
    accumulator 308.6 GB, so the step does not fit."""
    rec = pipeline_dryrun.run()
    per = 512 * 32 * 4_194_304
    assert rec["memory"]["argument_bytes"] == per * (4 + 4 + 1 + 4) + \
        512 * 32 * 12
    assert rec["fits"] is False
    assert rec["bytes_per_device"] >= rec["memory"]["argument_bytes"] + \
        512 * 50_220_423 * 3 * 4
    assert rec["flops_per_chip"] > 0 and rec["t_memory"] > rec["t_compute"]
    assert rec["collective_bytes_per_chip"] == 0.0
