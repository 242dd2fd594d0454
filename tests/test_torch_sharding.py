"""``repro_torch/sharding.py`` against ``src/repro/sharding.py`` on the CPU,
and the port's meshes and collectives without a process group.

Specs: every leaf of ``param_logical`` and ``kv_cache_logical`` of the five
LMs at full width, under all six profiles, on the meshes (16, 16), (2, 16,
16), (1, 4), (2, 2) and (4, 1): the port's ``resolve_spec`` (through
``transformer_lm.param_specs`` and ``serve_specs``) equals the
reference's, run on a ``jax.sharding.AbstractMesh`` (no devices), and so
does ``zero1_spec``.  The model zoo's five archs, full and reduced, on
(2, 2), (16, 16) and (2, 16, 16) under the ``tp`` profile: every
parameter's spec, its moments' ZeRO-1 spec, and at full width every
cell's ``build_bundle(..., device="meta", mesh=)`` in and out shardings
against the reference's ``build_bundle`` on the ``AbstractMesh``.  Specs
are compared as tuples of entries."""
import dataclasses
import itertools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, NamedSharding, \
    PartitionSpec

from repro import sharding as jsh
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import transformer_lm as JT
from repro_torch import collectives as C
from repro_torch import sharding as tsh
from repro_torch.configs import registry as tregistry
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import param_tree
from repro_torch.models import transformer_lm as TT
from repro_torch.train import optimizer as opt_lib

LMS = ["qwen2-1.5b", "glm4-9b", "internlm2-1.8b", "olmoe-1b-7b",
       "llama4-scout-17b-a16e"]
ZOO = ["dcn-v2", "autoint", "dien", "mind", "gat-cora"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}


def ref_mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def port_mesh(name):
    return tmesh.Mesh(*MESHES[name])


def entries(spec):
    return tuple(spec)


def flat(tree, prefix=""):
    """path -> leaf of a nest of dicts (a reference PartitionSpec or a
    port spec is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def ref_abstract(arch_id):
    cfg = jregistry.get_arch(arch_id).model_cfg()
    return cfg, jax.eval_shape(lambda: JT.init_params(cfg, jax.random.key(0)))


@pytest.mark.parametrize("arch_id", LMS)
def test_param_shapes_and_profile_knobs_match_reference(arch_id):
    jcfg, aparams = ref_abstract(arch_id)
    tcfg = tregistry.get_arch(arch_id).model_cfg()
    assert (tcfg.sharding_profile, tcfg.seq_parallel) == \
        (jcfg.sharding_profile, jcfg.seq_parallel)
    want = {k: tuple(v.shape) for k, v in flat(aparams).items()}
    assert flat(TT.param_shapes(tcfg)) == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch_id", LMS)
def test_specs_match_reference(arch_id, mesh_name):
    """All six profiles: every parameter leaf, its ZeRO-1 extension, and
    each serve cell's tokens, cache, logits and residual."""
    jcfg, aparams = ref_abstract(arch_id)
    tcfg = tregistry.get_arch(arch_id).model_cfg()
    jm, tm = ref_mesh(mesh_name), port_mesh(mesh_name)
    logical = JT.param_logical(jcfg)
    for prof in jsh.PROFILES:
        jprof = jsh.PROFILES[prof](jm)
        assert tsh.PROFILES[prof](tm) == jprof, prof
        want = flat(jsh.pspec_tree(aparams, logical, jm, jprof))
        tc = dataclasses.replace(tcfg, sharding_profile=prof)
        got = flat(TT.param_specs(tc, tm))
        assert got.keys() == want.keys()
        shapes = flat(TT.param_shapes(tc))
        zero1 = flat(tsh.zero1_sharding_tree(TT.param_shapes(tc),
                                             TT.param_specs(tc, tm), tm))
        for key in want:
            assert entries(got[key]) == entries(want[key]), (prof, key)
            assert entries(zero1[key]) == \
                entries(jsh.zero1_spec(want[key], shapes[key], jm)), \
                (prof, key)
        for shape_name, cell in LM_SHAPES.items():
            if cell["kind"] == "train":
                continue
            B = cell["batch"]
            S, T = (cell["seq"], cell["seq"]) if cell["kind"] == "prefill" \
                else (1, cell["kv_len"])
            got = TT.serve_specs(tc, tm, B, S, T)
            jc = JT.kv_cache_logical()["k"].names
            cache_shape = (jcfg.n_layers, B, T, jcfg.n_kv, jcfg.d_head)
            res = (jsh.BATCH, "model" if jcfg.seq_parallel else None, None)
            ref = {"tokens": jsh.resolve_spec((jsh.BATCH, None), (B, S), jm,
                                              jprof),
                   "cache": jsh.resolve_spec(jc, cache_shape, jm, jprof),
                   "logits": jsh.resolve_spec((jsh.BATCH, jsh.VOCAB),
                                              (B, jcfg.vocab), jm, jprof),
                   "residual": jsh.resolve_spec(res, (B, S, jcfg.d_model),
                                                jm, jprof)}
            for key in ref:
                assert entries(got[key]) == entries(ref[key]), \
                    (prof, shape_name, key)


def test_known_layouts():
    """The layouts the mesh path is built around, on (1, 4) and (16, 16):
    qwen2's cache sequence-sharded with its heads whole, its wk
    head_dim-sharded; olmoe's batch-1 cache over both axes; glm4's
    residual keeps its sequence (no profile has a rule for "model")."""
    P = tsh.P
    qwen = tregistry.get_arch("qwen2-1.5b").model_cfg()
    m14 = port_mesh("1x4")
    cache = TT.serve_specs(qwen, m14, 128, 1, 32768)["cache"]
    assert cache == P(None, "data", "model", None, None)
    attn = TT.param_specs(qwen, m14)["layers"]["attn"]
    assert attn["wk"] == P(None, "data", None, "model")
    assert attn["wq"] == P(None, "data", "model", None)
    olmoe = tregistry.get_arch("olmoe-1b-7b").model_cfg()
    assert TT.serve_specs(olmoe, port_mesh("2x2"), 1, 1, 524288)["cache"] \
        == P(None, None, ("data", "model"), None, None)
    glm = tregistry.get_arch("glm4-9b").model_cfg()
    for S in (1, 32768):
        assert TT.serve_specs(glm, port_mesh("16x16"), 32, S, 32768)[
            "residual"] == P("data", None, None)


def test_local_shapes_and_slices():
    m = port_mesh("2x2")
    spec = tsh.P(None, ("data", "model"), "model")
    assert tsh.local_shape(spec, (3, 8, 4), m) == (3, 2, 2)
    blocks = set()
    for d, mo in itertools.product(range(2), range(2)):
        sl = tsh.local_slices(tsh.P(("data", "model")), (8,), m,
                              {"data": d, "model": mo})
        blocks.add((sl[0].start, sl[0].stop))
        assert sl[0].start == 2 * (2 * d + mo)
    assert len(blocks) == 4
    assert tsh.local_slices(tsh.P(), (5, 6), m, m.coords) == \
        (slice(0, 5), slice(0, 6))


def test_meshes():
    for mp, (shape, axes) in ((False, MESHES["16x16"]),
                              (True, MESHES["2x16x16"])):
        m = tmesh.make_production_mesh(multi_pod=mp)
        assert (tuple(m.shape.values()), m.axis_names) == (shape, axes)
        assert m.size == (512 if mp else 256) and not m.live
        assert m.coords == {a: 0 for a in axes}
    host = tmesh.make_host_mesh()
    assert host.size == 1 and host.axis_names == ("data", "model")
    assert tmesh.NVLINK_BW == 450e9
    assert tmesh._coords(6, (2, 2, 2), ("pod", "data", "model")) == \
        {"pod": 1, "data": 1, "model": 0}
    assert port_mesh("2x2").axes(("model", "data")) == ("data", "model")
    assert port_mesh("4x1").axes(("data", "model")) == ("data",)


def test_collectives_on_a_shape_only_mesh_record_the_reference_volumes():
    """On ``meta`` each call makes its result's shape, moves nothing and
    records hlo_cost's volume: all-reduce 2x its operand, all-gather its
    result, reduce-scatter and all-to-all the larger of the two."""
    m = port_mesh("2x2")
    x = torch.empty(4, 6, 8, dtype=torch.bfloat16, device="meta")
    with C.recording() as rec:
        assert C.all_gather(x, m, ("data", "model"), 1).shape == (4, 24, 8)
        assert C.all_gather(x, m, "model", 0).shape == (8, 6, 8)
        assert C.all_reduce(x, m, "data") is x
        assert C.reduce_scatter(x, m, "model", 2).shape == (4, 6, 4)
        assert C.all_to_all(x[:2], m, "model").shape == (2, 6, 8)
        # an axis of size 1 or none: no call, no record
        assert C.all_gather(x, port_mesh("4x1"), "model", 0) is x
    n = 4 * 6 * 8 * 2
    assert rec.bytes == {"all-gather": 4 * n + 2 * n, "all-reduce": 2 * n,
                         "reduce-scatter": n, "all-to-all": n // 2}
    assert rec.counts == {"all-gather": 2, "all-reduce": 1,
                          "reduce-scatter": 1, "all-to-all": 1}
    assert rec.total == sum(rec.bytes.values())
    with pytest.raises(RuntimeError, match="shape-only"):
        C.all_reduce(torch.zeros(3), m, "data")


def test_reference_kind_names():
    from repro.analysis import hlo_cost
    assert set(C.KINDS) <= set(hlo_cost.COLLECTIVES)


@pytest.mark.parametrize("n_q,n_kv,m", [(12, 2, 2), (12, 2, 4), (40, 8, 4),
                                        (24, 6, 4)])
def test_kv_heads_for_a_rank_of_q_heads(n_q, n_kv, m):
    """The kv heads a rank's block of q heads reads, in the layout the
    GQA core expects (local q head i reads local kv head i // G'), against
    each q head's own kv head (h // G): the slice cases and the gather."""
    from repro_torch.models.layers import _kv_for_heads
    k = torch.randn(1, 3, n_kv, 4)
    v = torch.randn(1, 3, n_kv, 4)
    n = n_q // m
    for r in range(m):
        kl, vl = _kv_for_heads(k, v, r * n, n, n_q)
        g = n // kl.shape[2]
        for i in range(n):
            want = (r * n + i) // (n_q // n_kv)
            assert torch.equal(kl[:, :, i // g], k[:, :, want])
            assert torch.equal(vl[:, :, i // g], v[:, :, want])


def spec_leaves(tree, prefix="") -> dict:
    """path -> entries (trailing Nones dropped) of every spec in a nest of
    dicts, lists and tuples: the port's ``P``, the reference's
    ``PartitionSpec`` or ``NamedSharding``."""
    if isinstance(tree, NamedSharding):
        tree = tree.spec
    if isinstance(tree, (tsh.P, PartitionSpec)):
        e = list(tree)
        while e and e[-1] is None:
            e.pop()
        return {prefix: tuple(e)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(spec_leaves(v, f"{prefix}{k}/"))
    return out


def _zoo_cfgs(arch_id, size):
    ja, ta = jregistry.get_arch(arch_id), tregistry.get_arch(arch_id)
    if size == "full":
        return ja.model_cfg(), ta.model_cfg()
    return ja.reduced()[0], ta.reduced()[0]


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("mesh_name", ["2x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch_id", ZOO)
def test_zoo_specs_match_reference(arch_id, mesh_name, size):
    """Every zoo parameter's spec (the tree built on the mesh, and
    ``param_tree.state_specs``) and its moments' (``mesh_layout``, and the
    moment shards ``optimizer.init`` makes) against the reference's
    ``pspec_tree`` and ``zero1_spec`` under ``tp``; at full width every
    cell's bundle's in and out shardings against the reference's
    ``build_bundle``."""
    jcfg, tcfg = _zoo_cfgs(arch_id, size)
    jmod = jregistry.get_arch(arch_id).module
    tmod = tregistry.get_arch(arch_id).module
    jm, tm = ref_mesh(mesh_name), port_mesh(mesh_name)
    abstract = jax.eval_shape(lambda: jmod.init_params(jcfg,
                                                       jax.random.key(0)))
    jspecs = jsh.pspec_tree(abstract, jmod.param_logical(jcfg), jm,
                            jsh.PROFILES["tp"](jm))
    want = spec_leaves(jspecs)
    shapes = {p: a.shape for p, a in zip(want, jax.tree.leaves(abstract))}
    want_m = {p: spec_leaves(jsh.zero1_spec(s, shapes[p], jm))[""]
              for p, s in zip(want, jax.tree.leaves(
                  jspecs, is_leaf=lambda x: isinstance(x, PartitionSpec)))}
    tree = getattr(tmod, tsteps._CLASS[tmod.__name__.rsplit(".", 1)[-1]])(
        tcfg, "meta", mesh=tm)
    layout = opt_lib.mesh_layout(tree)
    moments = opt_lib.init(tree)["m"]
    got, got_m = {}, {}
    for name, p in tree.named_parameters():
        path = name.replace(".", "/") + "/"
        got[path] = spec_leaves(param_tree.leaf_spec(tree, name))[""]
        got_m[path] = spec_leaves(layout[name].mspec)[""]
        assert tuple(moments[name].shape) == tsh.local_shape(
            layout[name].mspec, shapes[path], tm), name
    assert got == want and got_m == want_m
    st = param_tree.state_specs(tmod, tcfg, tm)
    assert spec_leaves(st["params"]) == want
    assert spec_leaves(st["opt"]["m"]) == want_m
    if size == "reduced":
        return
    for shape in sorted(tregistry.get_arch(arch_id).shapes):
        jb = jsteps.build_bundle(arch_id, shape, jm)
        tb = tsteps.build_bundle(arch_id, shape, device="meta", mesh=tm)
        assert spec_leaves(tb.in_shardings) == spec_leaves(jb.in_shardings), \
            shape
        assert spec_leaves(tb.out_shardings) == \
            spec_leaves(jb.out_shardings), shape


def test_zoo_known_layouts():
    """The zoo's layouts on 2x2 at full width: the odd tables (DCN-v2's
    33,762,577 rows, AutoInt's 33,775,577, DIEN's 63,001 and 801)
    replicated, MIND's 100,000 over model; the MLP towers' columns over
    model, DCN-v2's out rows over model; AutoInt and GAT replicated.  At
    the reduced sizes the tables' rows are cut (AutoInt's 1,950 over 2,
    not 4)."""
    P = tsh.P

    def specs(arch_id, mesh_name, size="full"):
        cfg = _zoo_cfgs(arch_id, size)[1]
        return param_tree.param_specs(tregistry.get_arch(arch_id).module,
                                      cfg, port_mesh(mesh_name))

    dcn = specs("dcn-v2", "2x2")
    assert dcn["table"] == P(None, None)
    assert [m["w"] for m in dcn["mlp"]] == [P(None, "model")] * 3
    assert dcn["out"]["w"] == P("model", None)
    dien = specs("dien", "2x2")
    assert dien["item_table"] == dien["cate_table"] == P(None, None)
    assert dien["mlp"][0]["b"] == P("model") and \
        dien["out"]["w"] == P(None, None)
    assert specs("mind", "2x2")["item_table"] == P("model", None)
    assert set(spec_leaves(specs("autoint", "2x2")).values()) == {()}
    assert set(spec_leaves(specs("gat-cora", "16x16")).values()) == {()}
    assert specs("dcn-v2", "1x4", "reduced")["table"] == P("model", None)
    assert specs("autoint", "2x2", "reduced")["table"] == P("model", None)
    assert specs("autoint", "1x4", "reduced")["table"] == P(None, None)
