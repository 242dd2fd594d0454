"""The model zoo of the port against the JAX package on the CPU: DCN-v2,
AutoInt, DIEN, MIND and GAT on their reduced configs (forward, loss,
metrics, every gradient, three train steps), the recsys models'
``retrieval_score``, the embedding substrate, the weight-decay rule on the
zoo's list trees, the registry over all ten archs and the step formulas of
``launch/steps.py``.

Weights are the reference's ``init_params`` draw carried across by
``from_arrays``; batches are the reduced configs' numpy factories, fed to
both sides.  Every comparison is fp32 within atol 1e-5 + rtol 1e-4 of the
leaf's largest |value|: segment sums and GEMMs accumulate in another order
than XLA's, so values agree within rounding, not bit for bit."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models.recsys import embedding as JE
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import registry as tregistry
from repro_torch.launch import steps as tsteps
from repro_torch.models import param_tree
from repro_torch.models.recsys import dcn as tdcn
from repro_torch.models.recsys import dien as tdien
from repro_torch.models.recsys import embedding as TE
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts
from repro_torch.train.fault import StepGuard

ZOO = ["dcn-v2", "autoint", "dien", "mind", "gat-cora"]
RECSYS = ["dcn-v2", "autoint", "dien", "mind"]
LM_ARCHS = ["qwen2-1.5b", "glm4-9b", "internlm2-1.8b",
            "llama4-scout-17b-a16e", "olmoe-1b-7b"]
OPT = dict(lr=1e-3, total_steps=10)     # as tests/test_archs_smoke.py


def assert_leaf_close(got, want, what=""):
    """Within atol 1e-5 + rtol 1e-4 of the leaf's largest |value|."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = 1e-5 + 1e-4 * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound, err_msg=what)


def flat(tree) -> dict:
    """A JAX tree's leaves by dotted path (list indices as numbers), the
    names ``named_parameters()`` gives the port's module."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                        for k in path)
        out[name] = np.asarray(leaf)
    return out


def carry(arch_id, seed=0):
    """(reference cfg, params, module; port cfg, module; numpy batch)."""
    ja, ta = jregistry.get_arch(arch_id), tregistry.get_arch(arch_id)
    jcfg, batch_fn = ja.reduced()
    tcfg = ta.reduced()[0]
    params = ja.module.init_params(jcfg, jax.random.key(seed))
    mod = ta.module.from_arrays(tcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return jcfg, params, ja.module, tcfg, mod, ta.module, batch_fn()


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# ---------------------------------------------------------------------------
# forward, loss, metrics and every gradient; three train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ZOO)
def test_zoo_loss_and_grads_match_reference(arch_id):
    jcfg, params, jm, tcfg, mod, tm, b = carry(arch_id)
    jb, tb = jbatch(b), tbatch(b)
    with torch.no_grad():
        assert_leaf_close(tm.forward(tcfg, mod, tb),
                          jm.forward(jcfg, params, jb), "forward")
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, jb), has_aux=True)(params)
    for p in mod.parameters():
        p.requires_grad_(True)
    loss, met = tm.loss_fn(tcfg, mod, tb)
    names = [n for n, _ in mod.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        mod.parameters()))))
    assert_leaf_close(loss, jl, "loss")
    assert met.keys() == jmet.keys()
    for k in met:
        assert met[k].dtype == torch.float32, k
        assert_leaf_close(met[k], jmet[k], k)
    want = flat(jg)
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert_leaf_close(g, want[n], f"grad {n}")


@pytest.mark.parametrize("arch_id", ZOO)
def test_zoo_three_train_steps_match_reference(arch_id):
    """``make_train_step`` three times on one batch against the reference's
    jitted step: metrics each step and every parameter after each."""
    jcfg, params, jm, tcfg, mod, tm, b = carry(arch_id)
    jstep = jax.jit(jts.make_train_step(
        lambda p, bb: jm.loss_fn(jcfg, p, bb), jopt.AdamWConfig(**OPT)))
    tstep = ts.make_train_step(lambda p, bb: tm.loss_fn(tcfg, p, bb),
                               opt_lib.AdamWConfig(**OPT))
    jstate, state = jts.init_state(params), ts.init_state(mod)
    jb, tb = jbatch(b), tbatch(b)
    for i in range(3):
        jstate, jmet = jstep(jstate, jb)
        state, met = tstep(state, tb)
        assert met.keys() == jmet.keys()
        for k in met:
            assert_leaf_close(met[k], jmet[k], f"step {i + 1} {k}")
        want = flat(jstate["params"])
        for n, p in mod.named_parameters():
            assert_leaf_close(p, want[n], f"step {i + 1} {n}")
    assert int(state["opt"]["step"]) == 3


@pytest.mark.parametrize("arch_id", RECSYS)
def test_retrieval_score_matches_reference(arch_id):
    """The first row's context against candidates 0..63, as
    tests/test_archs_smoke.py::test_retrieval_scoring_paths, by value."""
    jcfg, params, jm, tcfg, mod, tm, b = carry(arch_id, seed=2)
    one = {k: v[:1] for k, v in b.items()}
    one["candidates"] = np.arange(64, dtype=np.int32)
    with torch.no_grad():
        got = tm.retrieval_score(tcfg, mod, tbatch(one))
    want = jm.retrieval_score(jcfg, params, jbatch(one))
    assert got.shape == (64,)
    assert_leaf_close(got, want, arch_id)


def test_dien_retrieval_chunks_equal_one_forward(monkeypatch):
    """DIEN scores candidates RETRIEVAL_CHUNK at a time: each row depends
    on itself alone, so chunks of 5 (the last one short) give the values
    of one forward over all 64, and the reference's."""
    jcfg, params, jm, tcfg, mod, tm, b = carry("dien", seed=2)
    one = {k: v[:1] for k, v in b.items()}
    one["candidates"] = np.arange(64, dtype=np.int32)
    with torch.no_grad():
        monkeypatch.setattr(tdien, "RETRIEVAL_CHUNK", 65)
        whole = tdien.retrieval_score(tcfg, mod, tbatch(one))
        monkeypatch.setattr(tdien, "RETRIEVAL_CHUNK", 5)
        chunked = tdien.retrieval_score(tcfg, mod, tbatch(one))
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    assert_leaf_close(chunked, jm.retrieval_score(jcfg, params, jbatch(one)))


# ---------------------------------------------------------------------------
# the embedding substrate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(combiner, weighted):
    """Segments 0..5 of 20 ids, segment 3 empty: the reference's zeros
    (sum, mean) and -inf (max) there."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((30, 4)).astype(np.float32)
    idx = rng.integers(0, 30, 20).astype(np.int32)
    seg = np.sort(rng.choice([0, 1, 2, 4, 5], 20)).astype(np.int32)
    w = rng.random(20).astype(np.float32) if weighted else None
    want = JE.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                            jnp.asarray(seg), 6, combiner=combiner,
                            weights=None if w is None else jnp.asarray(w))
    got = TE.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                           torch.from_numpy(seg), 6, combiner=combiner,
                           weights=None if w is None else torch.from_numpy(w))
    want = np.asarray(want)
    assert np.all(want[3] == (-np.inf if combiner == "max" else 0.0))
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    keep = [0, 1, 2, 4, 5]
    assert_leaf_close(got[keep], want[keep], combiner)
    with pytest.raises(ValueError):
        TE.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                         torch.from_numpy(seg), 6, combiner="median")


def test_field_table_lookup_keeps_the_ids_dtype():
    """The offsets are added in the ids' dtype; the Criteo table's rows
    (33,762,577) and its last field's offset fit int32."""
    vocabs = [3, 5, 7]
    jt, tt = JE.FieldTable(vocabs, 2), TE.FieldTable(vocabs, 2)
    np.testing.assert_array_equal(tt.offsets, jt.offsets)
    assert tt.total_rows == jt.total_rows == 15
    table = np.arange(30, dtype=np.float32).reshape(15, 2)
    cat = np.array([[0, 4, 6], [2, 0, 1]], np.int32)
    got = tt.lookup(torch.from_numpy(table), torch.from_numpy(cat))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jt.lookup(jnp.asarray(table),
                                          jnp.asarray(cat))))
    criteo = TE.FieldTable(TE.CRITEO_VOCABS, 16)
    assert criteo.total_rows == 33_762_577 < 2 ** 31
    assert TE.CRITEO_VOCABS == JE.CRITEO_VOCABS


@pytest.mark.parametrize("arch_id", ZOO)
def test_init_params_follow_the_reference_tree(arch_id):
    """``init_params`` gives the reference's tree (paths, shapes, dtypes)
    and its scale law: biases zero, each drawn leaf's std within 15 % of
    the reference draw's; ``to_arrays`` inverts ``from_arrays``."""
    jcfg, params, jm, tcfg, mod, tm, b = carry(arch_id)
    drawn = tm.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    want = flat(params)
    got = dict(drawn.named_parameters())
    assert sorted(got) == sorted(want)
    for n, p in got.items():
        assert tuple(p.shape) == want[n].shape and p.dtype == torch.float32
        assert not p.requires_grad, n
        ref_std = float(want[n].std())
        if ref_std == 0.0:
            assert not p.any(), n
        elif p.numel() >= 64:
            assert abs(float(p.std()) / ref_std - 1) < 0.15, n
    back = flat(tm.to_arrays(mod))
    assert sorted(back) == sorted(want)
    for n, a in want.items():
        np.testing.assert_array_equal(back[n], a)
    with pytest.raises(ValueError, match="shape"):
        param_tree.load_arrays(mod, jax.tree.map(
            lambda a: np.zeros((1, *a.shape), np.float32), params))


# ---------------------------------------------------------------------------
# weight decay on the zoo's list trees
# ---------------------------------------------------------------------------


def test_update_does_not_decay_zoo_biases():
    """One AdamW update of DCN's reduced module with non-zero biases, a
    constant schedule, no warm-up, lr 1e-2 and decay 0.1, equals the
    reference's ``update`` on the same tree: the 1-D ``cross.*.b`` and
    ``mlp.*.b`` are not decayed (the reference's lists hold unstacked
    leaves), the 2-D leaves are."""
    jcfg, params, jm, tcfg, mod, tm, b = carry("dcn-v2")
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape).astype(np.float32)
                   if a.ndim == 1 else np.asarray(a)), params)
    mod = tdcn.from_arrays(tcfg, params, device="cpu")
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    cfg = dict(lr=1e-2, weight_decay=0.1, warmup_steps=0,
               schedule="constant")
    want, _, _ = jopt.update(jopt.AdamWConfig(**cfg),
                             jax.tree.map(jnp.asarray, grads),
                             jopt.init(params),
                             jax.tree.map(jnp.asarray, params))
    tgrads = {n: torch.from_numpy(a) for n, a in flat(grads).items()}
    opt_lib.update(opt_lib.AdamWConfig(**cfg), tgrads, opt_lib.init(mod),
                   mod)
    want = flat(want)
    for n, p in mod.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    assert opt_lib.stacked_leaves(mod) == set()


def test_named_leaves_descend_into_lists():
    """A dict tree with lists (the reference's zoo layout) names each list
    leaf by its index and stacks none of them; neither does a dict keyed
    by layer numbers: only a module's ``stacked_prefixes`` stack."""
    tree = {"cross": [{"w": torch.ones(2, 2), "b": torch.ones(2)}],
            "layers": {"0": {"ln": torch.ones(2)}}}
    assert sorted(opt_lib.named_leaves(tree)) == \
        ["cross.0.b", "cross.0.w", "layers.0.ln"]
    assert opt_lib.stacked_leaves(tree) == set()


# ---------------------------------------------------------------------------
# checkpoints of the zoo's list trees, both ways
# ---------------------------------------------------------------------------


def _zoo_states(arch_id):
    """The reference's train state of the reduced arch with nonzero
    moments, and the port's train state of zeros to restore into."""
    jcfg, params, jm, tcfg, mod, tm, b = carry(arch_id)
    rng = np.random.default_rng(9)
    noise = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), params)
    jstate = {"params": params,
              "opt": {"m": noise, "v": jax.tree.map(jnp.square, noise),
                      "step": jnp.asarray(5, jnp.int32)}}
    zeros = tm.from_arrays(tcfg, jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), params), device="cpu")
    return jstate, ts.init_state(zeros)


def _assert_state_equal(state, jstate):
    want = flat(jstate["params"])
    got = dict(state["params"].named_parameters())
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n].detach().numpy(), want[n], n)
    for mom in ("m", "v"):
        for n, a in flat(jstate["opt"][mom]).items():
            np.testing.assert_array_equal(state["opt"][mom][n].numpy(), a)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"])


@pytest.mark.parametrize("arch_id", ["dcn-v2", "gat-cora"])
def test_zoo_checkpoint_both_ways(arch_id, tmp_path):
    """The reference saves a zoo train state, whose lists keep their index
    in each path (``params/cross/0/w``); the port restores it leaf for
    leaf, and its own save writes the same manifest and bytes, which the
    reference restores.  The port also reads the stacked layout that it
    wrote for these trees before stacking was declared."""
    jstate, state = _zoo_states(arch_id)
    jdir = jckpt.save(tmp_path / "jax", 5, jstate)
    man = json.loads((jdir / "manifest.json").read_text())
    listed = "params/cross/0/w" if arch_id == "dcn-v2" else \
        "params/layers/0/w"
    assert listed in man["leaves"]
    assert "opt/m/" + listed[len("params/"):] in man["leaves"]
    ckpt.restore(tmp_path / "jax", 5, state)
    _assert_state_equal(state, jstate)

    pdir = ckpt.save(tmp_path / "port", 5, state)
    assert json.loads((pdir / "manifest.json").read_text()) == man
    for meta in man["leaves"].values():
        assert (pdir / meta["file"]).read_bytes() == \
            (jdir / meta["file"]).read_bytes(), meta["file"]
    out = jckpt.restore(tmp_path / "port", 5,
                        jax.tree.map(jnp.zeros_like, jstate))
    _assert_state_equal(state, out)

    stacks: dict = {}
    for key in man["leaves"]:
        parts = key.split("/")
        i = next(j for j, p in enumerate(parts) if p.isdigit()) \
            if any(p.isdigit() for p in parts) else None
        arr = np.load(jdir / man["leaves"][key]["file"])
        if i is None:
            stacks[key] = [(0, arr)]
        else:
            stacks.setdefault("/".join(parts[:i] + parts[i + 1:]),
                              []).append((int(parts[i]), arr))
    old = {}
    for key, arrs in stacks.items():
        if key in man["leaves"]:
            old[key] = (arrs[0][1], man["leaves"][key]["dtype"])
        elif len({a.shape for _, a in arrs}) == 1:
            old[key] = (np.stack([a for _, a in sorted(arrs,
                                                       key=lambda e: e[0])]),
                        "float32")
        else:       # layers of unequal shapes never stacked: indexed
            for i, a in arrs:
                parts = key.split("/")
                j = len(parts) - 1
                old["/".join(parts[:j] + [str(i)] + parts[j:])] = \
                    (a, "float32")
    # DCN-v2's cross layers are equal in shape and stack; GAT's do not
    assert any(k not in man["leaves"] for k in old) == (arch_id == "dcn-v2")
    ckpt._write(tmp_path / "stacked", 5, old)
    _, fresh = _zoo_states(arch_id)
    ckpt.restore(tmp_path / "stacked", 5, fresh)
    _assert_state_equal(fresh, jstate)


def test_zoo_stepguard_resume_is_bit_equal(tmp_path):
    """Three DCN-v2 train steps under a ``StepGuard``, checkpointed each
    step: a run stopped after two, restored into a fresh model and resumed
    for the third ends bit-equal to the run that was not stopped, in
    every parameter and moment."""
    arch = tregistry.get_arch("dcn-v2")
    cfg, batch_fn = arch.reduced()
    base = batch_fn()

    def make(step, shard=0, n_shards=1):
        b = dict(base)
        b["label"] = np.roll(base["label"], step)
        return b

    pipeline = data_lib.DataPipeline(make)
    step_fn = ts.make_train_step(
        lambda p, bb: tdcn.loss_fn(cfg, p, bb), opt_lib.AdamWConfig(**OPT))

    def fresh():
        return ts.init_state(tdcn.init_params(
            cfg, torch.Generator("cpu").manual_seed(0), device="cpu"))

    whole, _, n = StepGuard(tmp_path / "whole", ckpt_every=1).run(
        fresh(), pipeline.iter_from, step_fn, 3)
    assert n == 3
    part, _, n = StepGuard(tmp_path / "part", ckpt_every=1).run(
        fresh(), pipeline.iter_from, step_fn, 2)
    assert n == 2 and ckpt.latest_step(tmp_path / "part") == 2
    resumed = ckpt.restore(tmp_path / "part", 2, fresh())
    assert int(resumed["opt"]["step"]) == 2
    resumed, _, n = StepGuard(tmp_path / "part", ckpt_every=1).run(
        resumed, pipeline.iter_from, step_fn, 3, start_step=2)
    assert n == 3
    for (name, a), b in zip(whole["params"].named_parameters(),
                            resumed["params"].parameters()):
        assert torch.equal(a, b), name
    for mom in ("m", "v"):
        for name, a in whole["opt"][mom].items():
            assert torch.equal(a, resumed["opt"][mom][name]), (mom, name)
    assert int(resumed["opt"]["step"]) == 3


# ---------------------------------------------------------------------------
# the registry over all ten archs and launch/steps.py's formulas
# ---------------------------------------------------------------------------


def cfg_fields(cfg) -> dict:
    """A config's fields with the dtype by name (jnp.float32 and
    torch.float32 alike are "float32")."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = str(v).split(".")[-1].split("'")[0]
        out[f.name] = v
    return out


def test_registry_resolves_every_reference_arch():
    assert tregistry.all_arch_ids() == jregistry.all_arch_ids()
    assert len(tregistry.all_arch_ids()) == 10
    for arch_id in tregistry.all_arch_ids():
        ta, ja = tregistry.get_arch(arch_id), jregistry.get_arch(arch_id)
        assert ta.family == ja.family, arch_id
        assert ta.module.__name__.startswith("repro_torch.models."), arch_id
        assert ta.module.__name__.split(".")[-1] == \
            ja.module.__name__.split(".")[-1]
        assert ta.shapes == ja.shapes


@pytest.mark.parametrize("arch_id", ZOO)
def test_zoo_configs_match_reference(arch_id):
    """``model_cfg(shape)`` for every shape, and ``reduced()`` with its
    batch, field by field."""
    ta, ja = tregistry.get_arch(arch_id), jregistry.get_arch(arch_id)
    for shape in ja.shapes:
        assert cfg_fields(ta.model_cfg(shape)) == \
            cfg_fields(ja.model_cfg(shape)), shape
    (tc, tb), (jc, jb) = ta.reduced(), ja.reduced()
    assert cfg_fields(tc) == cfg_fields(jc)
    tb, jb = tb(), jb()
    assert tb.keys() == jb.keys()
    for k in tb:
        assert tb[k].dtype == jb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("arch_id", ZOO + LM_ARCHS)
def test_step_flops_match_reference(arch_id):
    """``_recsys_flops``, ``_gnn_flops`` and ``_lm_model_flops`` for every
    (arch, shape), and ``_recsys_inputs``' shapes and dtypes."""
    ta, ja = tregistry.get_arch(arch_id), jregistry.get_arch(arch_id)
    for shape, cell in ja.shapes.items():
        tc, jc = ta.model_cfg(shape), ja.model_cfg(shape)
        if ja.family == "recsys":
            B = cell.get("candidates", cell["batch"])
            assert tsteps._recsys_flops(arch_id, tc, B, cell["kind"]) == \
                jsteps._recsys_flops(arch_id, jc, B, cell["kind"])
            got = tsteps._recsys_inputs(arch_id, tc, cell["batch"])
            want = jsteps._recsys_inputs(arch_id, jc, cell["batch"])
            assert got.keys() == want.keys()
            for k, (shp, dt) in got.items():
                assert shp == want[k].shape, (shape, k)
                assert str(dt).split(".")[-1] == str(want[k].dtype), k
        elif ja.family == "gnn":
            n, e = ((cell["n_graphs"] * cell["nodes_per_graph"],
                     cell["n_graphs"] * cell["edges_per_graph"])
                    if "n_graphs" in cell else
                    (cell["n_nodes"], cell["n_edges"]))
            assert tsteps._gnn_flops(tc, n, e) == \
                jsteps._gnn_flops(jc, n, e)
        else:
            tokens = cell["batch"] * cell.get("seq", 1)
            for kind in ("train", "serve"):
                assert tsteps._lm_model_flops(tc, tokens, kind) == \
                    jsteps._lm_model_flops(jc, tokens, kind)
    with pytest.raises(ValueError):
        tsteps._recsys_flops("gpt-9", None, 1, "train")
