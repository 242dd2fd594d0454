"""The port's LM (``models/transformer_lm.py``, the greedy decode of
``core/stages.py``) against the JAX package on the CPU.

Weights are the JAX package's ``init_params`` draw, carried across with
``lm_from_arrays``, so both sides compute one function.  In float32 the
prefill logits and the KV cache agree within 1e-4 (28 matmul sums in two
orders) and greedy tokens are equal; in bfloat16 each side rounds its
activations at the same cast points but sums in its own order, so logits
are held within 3 % of their largest magnitude.  The JAX "pallas" path
runs in interpret mode.  The RAG pipeline is tests/test_torch_rag.py."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import glm4_9b as jglm4
from repro.configs import internlm2_1_8b as jinternlm2
from repro.configs import qwen2_1_5b as jqwen
from repro.core.stages import greedy_generate_fn as jgreedy
from repro.models import transformer_lm as JT
from repro_torch.configs import glm4_9b as tglm4
from repro_torch.configs import internlm2_1_8b as tinternlm2
from repro_torch.configs import qwen2_1_5b as tqwen
from repro_torch.core.stages import greedy_generate_fn
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer_lm as TT

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tiny_jcfg(dtype="float32", impl="xla"):
    return JT.LMConfig(name="tiny", n_layers=2, d_model=32, n_q=4, n_kv=2,
                       d_head=8, d_ff=64, vocab=128, remat=False,
                       dtype=DT[dtype][0], attn_impl=impl)


def _port_cfg(jcfg):
    """The port's LMConfig with the same fields as a JAX one (its
    MoEConfig too)."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(TT.LMConfig)
          if f.name not in ("dtype", "moe")}
    moe = (None if jcfg.moe is None
           else TM.MoEConfig(**dataclasses.asdict(jcfg.moe)))
    return TT.LMConfig(**kw, moe=moe,
                       dtype=DT[jnp.dtype(jcfg.dtype).name][1])


def _carry(jcfg, seed=0):
    """(JAX params, the port's LM on the CPU with the same weights)."""
    params = JT.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return params, TT.lm_from_arrays(_port_cfg(jcfg), tree, "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


CASES = {"tiny float32": (lambda: _tiny_jcfg("float32"), 1e-4),
         "tiny bfloat16": (lambda: _tiny_jcfg("bfloat16"), None),
         "qwen2 reduced": (lambda: jqwen.reduced()[0], None),
         "glm4 reduced": (lambda: jglm4.reduced()[0], None),
         "internlm2 reduced": (lambda: jinternlm2.reduced()[0], None)}


def _close(got, want, tol):
    """float32: within ``tol``; bfloat16: within 3 % of the largest
    magnitude (each side rounds to bf16 after sums in its own order)."""
    got, want = _f32(got), _f32(want)
    atol = tol if tol is not None else 0.03 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol or 0.0, atol=atol)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_reference(case, impl):
    make, tol = CASES[case]
    jcfg = dataclasses.replace(make(), attn_impl=impl)
    params, lm = _carry(jcfg)
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(3)
    B, P, T = 3, 32, 4
    toks = rng.integers(0, jcfg.vocab, (B, P), dtype=np.int32)
    jl, jc = jax.jit(functools.partial(JT.prefill, jcfg))(
        params, jnp.asarray(toks), JT.init_kv_cache(jcfg, B, P + T))
    tc = TT.init_kv_cache(cfg, B, P + T, device="cpu")
    tl, tc = TT.prefill(cfg, lm, torch.tensor(toks), tc)
    assert tl.dtype == cfg.dtype and tl.shape == (B, jcfg.vocab)
    _close(tl, jl, tol)
    _close(tc["k"], jc["k"], tol)
    _close(tc["v"], jc["v"], tol)
    nxt = rng.integers(0, jcfg.vocab, (B, 1), dtype=np.int32)
    jl, jc = jax.jit(functools.partial(JT.decode_step, jcfg))(
        params, jnp.asarray(nxt), jc, P)
    tl, tc = TT.decode_step(cfg, lm, torch.tensor(nxt), tc, P)
    _close(tl, jl, tol)
    _close(tc["k"], jc["k"], tol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_greedy_tokens_equal_in_float32(impl):
    jcfg = _tiny_jcfg("float32", impl)
    params, lm = _carry(jcfg, seed=1)
    prompts = np.random.default_rng(4).integers(2, 128, (4, 24),
                                                dtype=np.int32)
    want = jax.jit(jgreedy(jcfg, max_prompt_len=24, max_new_tokens=6))(
        params, jnp.asarray(prompts))
    got = greedy_generate_fn(_port_cfg(jcfg), max_prompt_len=24,
                             max_new_tokens=6)(lm, torch.tensor(prompts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qwen2_configs_match_reference():
    full = tqwen.model_cfg()
    assert _port_cfg(jqwen.model_cfg()) == full
    assert full.params_dense == jqwen.model_cfg().params_dense
    assert _port_cfg(jqwen.reduced()[0]) == tqwen.reduced()[0]
    np.testing.assert_array_equal(tqwen.reduced()[1]()["tokens"],
                                  jqwen.reduced()[1]()["tokens"])


@pytest.mark.parametrize("jmod,tmod", [(jglm4, tglm4),
                                       (jinternlm2, tinternlm2)])
def test_dense_configs_match_reference(jmod, tmod):
    """glm4-9b and internlm2-1.8b field by field (the JAX configs' sharding
    fields have no counterpart in the port), their sizes and reduced
    batches."""
    full = tmod.model_cfg()
    assert _port_cfg(jmod.model_cfg()) == full
    for prop in ("params_dense", "params_total", "params_active"):
        assert getattr(full, prop) == getattr(jmod.model_cfg(), prop)
    assert _port_cfg(jmod.reduced()[0]) == tmod.reduced()[0]
    np.testing.assert_array_equal(tmod.reduced()[1]()["tokens"],
                                  jmod.reduced()[1]()["tokens"])


def test_lm_modules_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``device=None`` means the card, as at every entry point: without
    CUDA the LM's modules raise ``resolve_device``'s error, and build on
    the CPU when asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TT.LMConfig(name="t", n_layers=1, d_model=8, n_q=2, n_kv=1,
                      d_head=4, d_ff=8, vocab=16)
    makers = [lambda d: TT.TransformerLM(cfg, device=d),
              lambda d: TT.Block(cfg, d),
              lambda d: TL.Attention(cfg.attn_dims(), cfg.dtype, d),
              lambda d: TL.MLP(cfg.d_model, cfg.d_ff, cfg.dtype, d)]
    for make in makers:
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            make(None)
        assert all(p.device.type == "cpu" for p in make("cpu").parameters())
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        TT.TransformerLM(cfg)


def test_every_config_builds():
    """Every arch of the registry builds its reduced config's model on the
    CPU (the five LMs and the model zoo), and an attention impl neither
    package has raises.  Every LM configuration of the JAX package builds:
    ``attn_impl="flash"`` (the training path's flash_attention_xla, equal
    to the JAX package's at the attention core), MoE layers and
    chunked-local attention on the kernel."""
    from repro.models import layers as JL
    from repro_torch.configs import registry
    for arch_id in registry.all_arch_ids():
        arch = registry.get_arch(arch_id)
        cfg = arch.reduced()[0]
        model = (TT.TransformerLM(cfg, device="cpu") if arch.family == "lm"
                 else arch.module.init_params(
                     cfg, torch.Generator().manual_seed(0), device="cpu"))
        assert all(p.device.type == "cpu" for p in model.parameters())
    dims = dict(n_layers=1, d_model=8, n_q=2, n_kv=1, d_head=4, d_ff=8,
                vocab=16)
    q = np.random.default_rng(0).standard_normal((1, 4, 2, 4), np.float32)
    kv = q[:, :, :1]
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    np.testing.assert_allclose(
        TL.gqa_attention(tq, tkv, tkv, None, impl="flash").numpy(),
        np.asarray(JL.gqa_attention(jnp.asarray(q), jnp.asarray(kv),
                                    jnp.asarray(kv), None, impl="flash")),
        atol=1e-6)
    with pytest.raises(ValueError, match="unknown attention impl"):
        TL.gqa_attention(tq, tkv, tkv, None, impl="ring")
    moe = TM.MoEConfig(n_experts=2, top_k=1, d_ff_expert=8)
    for cfg in (TT.LMConfig(name="f", attn_impl="flash", **dims),
                TT.LMConfig(name="m", moe=moe, **dims),
                TT.LMConfig(name="c", attn_chunk=4, attn_impl="pallas",
                            **dims)):
        TT.TransformerLM(cfg, device="cpu")
