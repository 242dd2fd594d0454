"""The port's mixture-of-experts layer (``models/moe.py``) and the MoE LMs
(olmoe-1b-7b, llama4-scout-17b-a16e: ``models/transformer_lm.py`` with
chunked-local attention) against the JAX package on the CPU.

One MoE layer's weights are the JAX ``moe_init`` draw, an LM's the JAX
``init_params`` draw, carried across as numpy arrays, so both sides compute
one function.  Routing is integer-exact: expert indices and the kept
assignments are equal; in float32 one layer's gates, output and aux
metrics agree within 1e-5 and an LM's logits and KV cache within 1e-4,
greedy tokens equal; in bfloat16 within 3 % of the largest magnitude.
The port's ``"pallas"`` path (the plain flash version on the CPU, with the
layer's chunk) is held to the JAX ``"xla"`` path, because the JAX
``"pallas"`` path drops the chunk (ROADMAP §3)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama4_scout_17b_a16e as jllama4
from repro.configs import olmoe_1b_7b as jolmoe
from repro.core.stages import greedy_generate_fn as jgreedy
from repro.models import moe as JM
from repro.models import transformer_lm as JT
from repro_torch.configs import llama4_scout_17b_a16e as tllama4
from repro_torch.configs import olmoe_1b_7b as tolmoe
from repro_torch.core.stages import greedy_generate_fn
from repro_torch.models import moe as TM
from repro_torch.models import transformer_lm as TT

from test_torch_generate import DT, _close, _port_cfg

# ---------------------------------------------------------------------------
# one MoE layer
# ---------------------------------------------------------------------------


def _port_moe(jp, d, cfg, dtype=torch.float32) -> TM.MoE:
    """The port's MoE layer with the weights of a JAX ``moe_init`` tree."""
    p = TM.MoE(d, cfg, dtype, "cpu")
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(p, name).copy_(torch.tensor(np.asarray(jp[name],
                                                           np.float32)))
        if cfg.n_shared:
            for name in ("w_gate", "w_up", "w_down"):
                getattr(p.shared, name).copy_(torch.tensor(
                    np.asarray(jp["shared"][name], np.float32)))
    return p


def _kept(expert_idx: np.ndarray, n_experts: int, capacity: int):
    """The reference's capacity rule as a loop: assignments token-major,
    each expert keeps its first ``capacity``."""
    seen = np.zeros(n_experts, np.int64)
    keep = []
    for e in expert_idx.reshape(-1):
        keep.append(seen[e] < capacity)
        seen[e] += 1
    return np.array(keep)


#: name -> (MoEConfig fields, d_model): the reduced configs' layers and the
#: shapes of tests/test_moe.py under both routers
LAYERS = {
    "olmoe-smoke": (dataclasses.asdict(jolmoe.reduced()[0].moe), 64),
    "llama4-smoke": (dataclasses.asdict(jllama4.reduced()[0].moe), 64),
    **{f"E{E} k{k} {act}": (dict(n_experts=E, top_k=k, d_ff_expert=16,
                                 router_act=act), 32)
       for E, k in ((4, 1), (8, 2), (16, 4))
       for act in ("softmax", "sigmoid")},
}


def _layer(name, dispatch, dtype="float32", seed=0, **over):
    fields, d = LAYERS[name]
    fields = {**fields, "dispatch": dispatch, **over}
    jcfg, tcfg = JM.MoEConfig(**fields), TM.MoEConfig(**fields)
    jp = JM.moe_init(jax.random.key(seed), d, jcfg, DT[dtype][0])
    return jcfg, tcfg, jp, _port_moe(jp, d, tcfg, DT[dtype][1]), d


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_moe_apply_matches_reference(name, dispatch):
    jcfg, tcfg, jp, tp, d = _layer(name, dispatch)
    x = np.random.default_rng(1).standard_normal((2, 16, d)).astype(
        np.float32)
    jg, ji, jm = JM._routing(jnp.asarray(x.reshape(-1, d)), jp["router"],
                             jcfg)
    tg, ti, tm = TM._routing(torch.tensor(x.reshape(-1, d)), tp.router, tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    C = TM.scatter_capacity(tcfg, 32)
    _, _, keep = TM.scatter_slots(ti, tcfg.n_experts, C)
    np.testing.assert_array_equal(keep.numpy(),
                                  _kept(np.asarray(ji), tcfg.n_experts, C))
    jout, jmet = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    tout, tmet = TM.moe_apply(tp, torch.tensor(x), tcfg)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for key in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)


@pytest.mark.parametrize("name", ["olmoe-smoke", "llama4-smoke"])
def test_moe_apply_matches_reference_in_bfloat16(name):
    jcfg, tcfg, jp, tp, d = _layer(name, "scatter", "bfloat16")
    x = np.random.default_rng(2).standard_normal((2, 16, d)).astype(
        np.float32)
    jout, _ = JM.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    tout, _ = TM.moe_apply(tp, torch.tensor(x).to(torch.bfloat16), tcfg)
    assert tout.dtype == torch.bfloat16
    _close(tout, jout, None)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_low_capacity_drops_the_same_tokens(dispatch):
    """At capacity factor 0.1 (8 slots an expert for 256 top-1 tokens)
    both packages keep the same assignments, and the dropped tokens'
    outputs are zero on both."""
    jcfg, tcfg, jp, tp, d = _layer("E8 k2 softmax", dispatch,
                                   capacity_factor=0.1, top_k=1)
    x = np.random.default_rng(2).standard_normal((1, 256, d)).astype(
        np.float32)
    _, ti, _ = TM._routing(torch.tensor(x[0]), tp.router, tcfg)
    C = TM.scatter_capacity(tcfg, 256)
    _, _, keep = TM.scatter_slots(ti, tcfg.n_experts, C)
    assert C == 8 and not keep.all()
    np.testing.assert_array_equal(keep.numpy(),
                                  _kept(ti.numpy(), tcfg.n_experts, C))
    jout, _ = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    tout, _ = TM.moe_apply(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    zero = np.linalg.norm(tout.numpy()[0], axis=-1) == 0
    if dispatch == "scatter":
        np.testing.assert_array_equal(zero, ~keep.numpy())
    assert zero.any() and np.isfinite(tout.numpy()).all()


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("name", ["olmoe-smoke", "llama4-smoke",
                                  "E16 k4 sigmoid"])
def test_padded_rows_leave_the_real_rows_routing_alone(name, dispatch):
    """2 real rows padded with 3 random rows to a bucket of 5: with
    ``n_rows`` 2 the capacity counts the real rows' tokens, so their
    outputs equal the JAX package's call on the 2 rows alone; without it
    the padded call's larger capacity keeps assignments that call drops."""
    jcfg, tcfg, jp, tp, d = _layer(name, dispatch, capacity_factor=0.5)
    x = np.random.default_rng(5).standard_normal((5, 16, d)).astype(
        np.float32)
    want, _ = JM.moe_apply(jp, jnp.asarray(x[:2]), jcfg)
    got, _ = TM.moe_apply(tp, torch.tensor(x), tcfg, n_rows=torch.tensor(2))
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert int(TM.moe_apply(tp, torch.tensor(x[:2]), tcfg)[1]["dropped"]) > 0
    unpadded = TM.moe_apply(tp, torch.tensor(x), tcfg)[0][:2]
    assert not np.allclose(unpadded.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_moe_metrics_count_the_load_and_the_drops(dispatch):
    """The metrics carry the routing: the experts picked (the reference's,
    as integers), the assignments each expert is given (their bincount)
    and the assignments dropped past capacity (the reference's rule, as a
    loop, at one group); pinning a call to its own routing changes
    nothing, pinning it elsewhere routes there."""
    jcfg, tcfg, jp, tp, d = _layer("E8 k2 softmax", dispatch,
                                   capacity_factor=0.5, group_size=256)
    x = np.random.default_rng(6).standard_normal((2, 64, d)).astype(
        np.float32)
    _, ji, _ = JM._routing(jnp.asarray(x.reshape(-1, d)), jp["router"], jcfg)
    ji = np.asarray(ji)
    out, met = TM.moe_apply(tp, torch.tensor(x), tcfg)
    np.testing.assert_array_equal(met["expert_idx"].numpy(), ji)
    np.testing.assert_array_equal(met["expert_load"].numpy(),
                                  np.bincount(ji.reshape(-1), minlength=8))
    C = (TM.scatter_capacity(tcfg, 2, 64) if dispatch == "scatter"
         else TM._slots(tcfg, tcfg.capacity_factor * tcfg.top_k * 128, 4))
    dropped = int((~_kept(ji, 8, C)).sum())
    assert dropped > 0 and int(met["dropped"]) == dropped
    pinned, _ = TM.moe_apply(tp, torch.tensor(x), tcfg,
                             expert_idx=met["expert_idx"])
    assert torch.equal(pinned, out)
    other = (met["expert_idx"] + 1) % 8
    _, om = TM.moe_apply(tp, torch.tensor(x), tcfg, expert_idx=other)
    assert torch.equal(om["expert_idx"], other)
    np.testing.assert_array_equal(om["expert_load"].numpy(), np.bincount(
        other.numpy().reshape(-1), minlength=8))


@pytest.mark.parametrize("name", ["E4 k1 sigmoid", "E8 k2 softmax",
                                  "E16 k4 softmax"])
def test_scatter_equals_einsum_when_nothing_drops(name):
    E = LAYERS[name][0]["n_experts"]
    _, tcfg, _, tp, d = _layer(name, "scatter", capacity_factor=float(E))
    ecfg = dataclasses.replace(tcfg, dispatch="einsum", group_size=64)
    x = torch.tensor(np.random.default_rng(1).standard_normal((2, 16, d)),
                     dtype=torch.float32)
    a, _ = TM.moe_apply(tp, x, tcfg)
    b, _ = TM.moe_apply(tp, x, ecfg)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_shared_expert_always_on():
    """With a shared expert even the dropped tokens' outputs are nonzero."""
    cfg = TM.MoEConfig(n_experts=8, top_k=1, d_ff_expert=16, n_shared=1,
                       d_ff_shared=16, capacity_factor=0.1)
    p = TM.moe_init(torch.Generator().manual_seed(3), 16, cfg,
                    torch.float32)
    x = torch.tensor(np.random.default_rng(3).standard_normal((1, 256, 16)),
                     dtype=torch.float32)
    out, _ = TM.moe_apply(p, x, cfg)
    _, idx, _ = TM._routing(x[0], p.router, cfg)
    keep = TM.scatter_slots(idx, 8, TM.scatter_capacity(cfg, 256))[2]
    assert not keep.all()
    assert (out[0].norm(dim=-1) > 0).all()


def test_moe_init_draws_each_expert_at_the_reference_scale():
    """``dense_init`` of an [E, d, f] tensor takes E as its fan-in: each
    expert, drawn alone, has the std of a ±3-truncated normal times
    E^-1/2; the router is fp32 at d^-1/2; the shared expert an MLP."""
    cfg = TM.MoEConfig(n_experts=16, top_k=1, d_ff_expert=256, n_shared=1,
                       d_ff_shared=128)
    p = TM.moe_init(torch.Generator().manual_seed(0), 128, cfg,
                    torch.float32)
    trunc = 0.9866      # std of the standard normal truncated at ±3
    assert p.router.dtype == torch.float32
    assert tuple(p.w_down.shape) == (16, 256, 128)
    for w in (p.w_gate, p.w_up, p.w_down):
        np.testing.assert_allclose(float(w.std()), trunc * 16 ** -0.5,
                                   rtol=0.02)
        assert not torch.equal(w[0], w[1])
    np.testing.assert_allclose(float(p.router.std()), trunc * 128 ** -0.5,
                               rtol=0.05)
    assert tuple(p.shared.w_gate.shape) == (128, 128)


# ---------------------------------------------------------------------------
# the MoE LMs
# ---------------------------------------------------------------------------

REDUCED = {"olmoe-smoke": jolmoe.reduced, "llama4-smoke": jllama4.reduced}


def _lm(name, impl="xla", seed=0):
    """(JAX cfg on the "xla" path in float32, its params, the port's cfg
    on ``impl``, the port's LM with the same weights)."""
    jcfg = dataclasses.replace(REDUCED[name]()[0], dtype=jnp.float32,
                               remat=False)
    params = JT.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    cfg = dataclasses.replace(_port_cfg(jcfg), attn_impl=impl)
    return jcfg, params, cfg, TT.lm_from_arrays(cfg, tree, "cpu")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(REDUCED))
def test_moe_lm_prefill_and_decode_match_reference(name, impl):
    """Prompts of 40 tokens cross llama4-smoke's chunk of 16, and its
    decode steps at 40 and 41 see the chunk from 32 alone."""
    jcfg, params, cfg, lm = _lm(name, impl)
    rng = np.random.default_rng(3)
    B, P, T = 3, 40, 4
    toks = rng.integers(0, jcfg.vocab, (B, P), dtype=np.int32)
    jl, jc = jax.jit(functools.partial(JT.prefill, jcfg))(
        params, jnp.asarray(toks), JT.init_kv_cache(jcfg, B, P + T))
    tc = TT.init_kv_cache(cfg, B, P + T, device="cpu")
    tl, tc = TT.prefill(cfg, lm, torch.tensor(toks), tc)
    assert tl.shape == (B, jcfg.vocab)
    _close(tl, jl, 1e-4)
    _close(tc["k"], jc["k"], 1e-4)
    _close(tc["v"], jc["v"], 1e-4)
    for pos in (P, P + 1):
        nxt = rng.integers(0, jcfg.vocab, (B, 1), dtype=np.int32)
        jl, jc = jax.jit(functools.partial(JT.decode_step, jcfg))(
            params, jnp.asarray(nxt), jc, pos)
        tl, tc = TT.decode_step(cfg, lm, torch.tensor(nxt), tc, pos)
        _close(tl, jl, 1e-4)
        _close(tc["k"], jc["k"], 1e-4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(REDUCED))
def test_moe_lm_greedy_tokens_equal_in_float32(name, impl):
    jcfg, params, cfg, lm = _lm(name, impl, seed=1)
    prompts = np.random.default_rng(4).integers(2, jcfg.vocab, (4, 24),
                                                dtype=np.int32)
    want = jax.jit(jgreedy(jcfg, max_prompt_len=24, max_new_tokens=6))(
        params, jnp.asarray(prompts))
    got = greedy_generate_fn(cfg, max_prompt_len=24, max_new_tokens=6)(
        lm, torch.tensor(prompts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reference_pallas_prefill_drops_the_chunk():
    """The recorded deviation: on llama4-smoke's chunked layer the JAX
    "pallas" prefill attends across the chunk boundary (it calls the
    kernel without the chunk), so its logits differ from its own "xla"
    path's, which the port's "pallas" path equals."""
    jcfg, params, cfg, lm = _lm("llama4-smoke", "pallas", seed=2)
    jpal = dataclasses.replace(jcfg, attn_impl="pallas")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 40),
                                             dtype=np.int32)
    out = {}
    for key, c in (("xla", jcfg), ("pallas", jpal)):
        out[key] = np.asarray(jax.jit(functools.partial(JT.prefill, c))(
            params, jnp.asarray(toks), JT.init_kv_cache(c, 2, 40))[0])
    got = TT.prefill(cfg, lm, torch.tensor(toks),
                     TT.init_kv_cache(cfg, 2, 40, device="cpu"))[0]
    _close(got, out["xla"], 1e-4)
    assert np.abs(out["pallas"] - out["xla"]).max() > 1e-2


def test_lm_from_arrays_carries_an_moe_tree():
    jcfg, params, cfg, lm = _lm("llama4-smoke")
    moe = params["layers"]["moe"]
    for i, blk in enumerate(lm.layers):
        assert not hasattr(blk, "mlp")
        assert blk.moe.router.dtype == torch.float32
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(getattr(blk.moe, name).numpy(),
                                          np.asarray(moe[name][i]))
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                getattr(blk.moe.shared, name).numpy(),
                np.asarray(moe["shared"][name][i]))
    # params_total (the reference's count) leaves ln_final out
    assert sum(p.numel() for p in lm.parameters()) == \
        cfg.params_total + cfg.d_model


@pytest.mark.parametrize("jmod,tmod", [(jolmoe, tolmoe), (jllama4, tllama4)])
def test_moe_configs_match_reference(jmod, tmod):
    for make in ("model_cfg", "reduced"):
        jcfg = getattr(jmod, make)()
        jcfg = jcfg[0] if make == "reduced" else jcfg
        tcfg = getattr(tmod, make)()
        tcfg = tcfg[0] if make == "reduced" else tcfg
        assert _port_cfg(jcfg) == tcfg
        assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(jcfg.moe)
        for prop in ("params_dense", "params_total", "params_active"):
            assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    np.testing.assert_array_equal(tmod.reduced()[1]()["tokens"],
                                  jmod.reduced()[1]()["tokens"])


def test_full_width_sizes():
    """The sizes PERF.md's cells G2 and G3 are planned from."""
    olmoe, llama = tolmoe.model_cfg(), tllama4.model_cfg()
    assert olmoe.params_total == 6_919_094_272
    assert llama.params_total == 107_769_856_000
    # Llama-4 at 8 of its 48 layers, the depth of cell G3
    cut = dataclasses.replace(llama, n_layers=8)
    emb = 2 * llama.vocab * llama.d_model
    assert round(2 * (cut.params_total - emb) / 8 / 1e9, 2) == 4.40
    assert round(2 * emb / 1e9, 2) == 4.14
    assert TM.scatter_capacity(olmoe.moe, 16 * 1024) == 2560
    assert TM.scatter_capacity(olmoe.moe, 16) == 8
    assert TM.scatter_capacity(llama.moe, 4 * 16384) == 5120


def test_moe_lm_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tolmoe.reduced()[0]
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        TM.MoE(cfg.d_model, cfg.moe)
    assert all(p.device.type == "cpu"
               for p in TM.MoE(cfg.d_model, cfg.moe, device="cpu")
               .parameters())
