"""The port's LM training (``forward``/``loss_fn`` with remat and the MoE
aux losses, ``make_train_step``, ``launch.train.train_lm``) against the JAX
package on the CPU, in float32.

Weights are the JAX ``init_params`` draw carried across with
``lm_from_arrays``; batches are ``lm_batch_fn``'s (numpy, the same on both
sides).  Each leaf is held within 1e-5 + 1e-4 x its largest magnitude:
logits, ``ce``, ``moe_aux``, ``moe_z`` and every gradient against
``jax.value_and_grad(loss_fn, has_aux=True)``, on the reduced configs of
all five LMs (Llama-4 at 4 layers, so that a global layer runs beside the
chunked ones), on the flash training path and the einsum path, the port
with remat on and off.  Routing is integer-exact before any gradient is
compared."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import glm4_9b as jglm4
from repro.configs import internlm2_1_8b as jinternlm2
from repro.configs import llama4_scout_17b_a16e as jllama4
from repro.configs import olmoe_1b_7b as jolmoe
from repro.configs import qwen2_1_5b as jqwen
from repro.launch import train as jlaunch
from repro.models import moe as JM
from repro.models import transformer_lm as JT
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.launch import train as tlaunch
from repro_torch.models import moe as TM
from repro_torch.models import transformer_lm as TT
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts
from repro_torch.train.data import lm_batch_fn

from test_torch_generate import _carry, _port_cfg
from test_torch_moe import _layer
from test_torch_train import _by_name

LMS = {"qwen2": (jqwen, {}), "glm4": (jglm4, {}),
       "internlm2": (jinternlm2, {}), "olmoe": (jolmoe, {}),
       "llama4": (jllama4, {"n_layers": 4})}


def _jcfg(name, impl, remat=True):
    mod, over = LMS[name]
    return dataclasses.replace(mod.reduced()[0], dtype=jnp.float32,
                               attn_impl=impl, remat=remat, **over)


def _close(got, want, what=""):
    """Within 1e-5 + 1e-4 x the largest |want| of the leaf."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=1e-5 + 1e-4 * float(np.abs(want).max()))


def _batch(vocab, B=2, S=32, step=0):
    return lm_batch_fn(vocab, B, S)(step)


def _jax_routes(jcfg, params, tokens):
    """Each MoE layer's expert_idx in the reference's forward, run without
    jit so the scan's body sees concrete values."""
    seen, routing = [], JM._routing

    def spy(xt, router, cfg):
        out = routing(xt, router, cfg)
        seen.append(np.asarray(out[1]))
        return out

    JM._routing = spy
    try:
        with jax.disable_jit():
            JT.forward(dataclasses.replace(jcfg, remat=False), params,
                       jnp.asarray(tokens))
    finally:
        JM._routing = routing
    return seen


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("name", list(LMS))
def test_loss_and_grads_match_reference(name, impl):
    jcfg = _jcfg(name, impl)
    params, lm = _carry(jcfg)
    batch = _batch(jcfg.vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, jaux), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(JT.loss_fn, jcfg), has_aux=True))(params, jbatch)
    jlogits, _ = jax.jit(functools.partial(JT.forward, jcfg))(
        params, jbatch["tokens"])
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    lm.requires_grad_(True)
    names = [n for n, _ in lm.named_parameters()]
    want_g = _by_name(jgrads)
    assert set(names) == set(want_g)
    grads = {}
    for remat in (True, False):
        cfg = dataclasses.replace(_port_cfg(jcfg), remat=remat)
        logits, _ = TT.forward(cfg, lm, tbatch["tokens"])
        _close(logits, jlogits, "logits")
        metrics = []
        total, aux = TT.loss_fn(cfg, lm, tbatch, metrics=metrics)
        if jcfg.moe:
            routes = _jax_routes(jcfg, params, batch["tokens"])
            assert len(metrics) == len(routes) == jcfg.n_layers
            for m, r in zip(metrics, routes):
                np.testing.assert_array_equal(m["expert_idx"].numpy(), r)
            assert set(aux) == set(jaux) == {"ce", "moe_aux", "moe_z"}
        else:
            assert metrics == [] and set(aux) == set(jaux) == {"ce"}
        _close(total, jtotal, "total")
        for key in jaux:
            _close(aux[key], jaux[key], key)
        g = torch.autograd.grad(total, list(lm.parameters()))
        grads[remat] = dict(zip(names, g))
        for n in names:
            _close(grads[remat][n], want_g[n], f"d{n} remat={remat}")
    for n in names:
        _close(grads[True][n], grads[False][n].numpy(), f"d{n} remat")


@pytest.mark.parametrize("k,E", [(1, 4), (3, 8)])
def test_moe_grads_match_reference(k, E):
    """One MoE layer's loss (sum of squares + aux + z, the reference's
    ``_check_moe_grads_finite``): gradients reach the router through the
    gates and both aux losses, the experts through the scatter dispatch,
    and equal the reference's."""
    jcfg, tcfg, jp, tp, d = _layer(f"E{E} k{k} softmax" if k == 1 else
                                   "E8 k2 softmax", "scatter",
                                   **({} if k == 1 else {"top_k": 3}))
    x = np.random.default_rng(4).standard_normal((1, 8, d)).astype(
        np.float32)

    def jloss(p):
        out, m = JM.moe_apply(p, jnp.asarray(x), jcfg)
        return jnp.sum(out ** 2) + m["moe_aux"] + m["moe_z"]

    jg = jax.grad(jloss)(jp)
    tp.requires_grad_(True)
    out, m = TM.moe_apply(tp, torch.tensor(x), tcfg)
    loss = out.square().sum() + m["moe_aux"] + m["moe_z"]
    tg = dict(zip([n for n, _ in tp.named_parameters()],
                  torch.autograd.grad(loss, list(tp.parameters()))))
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert torch.isfinite(tg[name]).all(), name
        assert float(tg[name].abs().max()) > 0, name
        _close(tg[name], jg[name], name)
    # the aux losses alone reach the router
    g_aux = torch.autograd.grad(
        TM.moe_apply(tp, torch.tensor(x), tcfg)[1]["moe_z"], tp.router)[0]
    assert float(g_aux.abs().max()) > 0


def _floor(jcfg, params, batch, n_micro):
    """Per port parameter name, the elements whose reference gradient (the
    micro-batches' mean) lies below 1e-4 of the leaf's largest: the
    gradient's own rounding floor, where the leaf bound is all error."""
    grad = jax.jit(jax.grad(lambda p, b: JT.loss_fn(jcfg, p, b)[0]))
    b = len(batch["tokens"]) // n_micro
    gs = [grad(params, {k: jnp.asarray(v[i * b:(i + 1) * b])
                        for k, v in batch.items()}) for i in range(n_micro)]
    g = _by_name(jax.tree.map(lambda *x: sum(x) / n_micro, *gs))
    return {n: np.abs(a) < 1e-4 * np.abs(a).max() for n, a in g.items()}


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("name", ["qwen2", "olmoe"])
def test_train_step_matches_reference(name, n_micro):
    """Three AdamW steps from the same weights and batches: loss, ce and
    grad_norm each step within rtol 1e-4, the first moments after step 3
    within the leaf bound, and the parameters within it wherever the
    gradient stood above its rounding floor at every step.  Adam divides
    each element by its own gradient's scale, so an element whose gradient
    is rounding noise (Qwen2's key bias on RoPE's slowest pairs, ~1e-5 of
    the leaf's largest) takes a step set by the noise: there the two
    packages are held within one step, the summed learning rate."""
    jcfg = _jcfg(name, "flash")
    params, lm = _carry(jcfg)
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jts.make_train_step(functools.partial(JT.loss_fn, jcfg),
                                        jopt.AdamWConfig(**opt),
                                        n_micro=n_micro))
    tstep = ts.make_train_step(functools.partial(TT.loss_fn, _port_cfg(jcfg)),
                               opt_lib.AdamWConfig(**opt), n_micro=n_micro)
    jstate, tstate = jts.init_state(params), ts.init_state(lm)
    assert all(p.requires_grad for p in lm.parameters())
    fn = lm_batch_fn(jcfg.vocab, 4, 32)
    floor, lr_sum = None, 0.0
    for step in range(3):
        batch = fn(step)
        f = _floor(jcfg, jstate["params"], batch, n_micro)
        floor = f if floor is None else {n: floor[n] | f[n] for n in f}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        assert set(tm) == set(jm)
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} {step}")
        lr_sum += float(jm["lr"])
    assert int(tstate["opt"]["step"]) == 3
    want = _by_name(jstate["params"])
    for n, p in lm.named_parameters():
        got, lo = p.detach().numpy(), floor[n]
        _close(got[~lo], want[n][~lo], n)
        assert np.all(np.abs(got[lo] - want[n][lo]) <= lr_sum), n
    want_m = _by_name(jstate["opt"]["m"])
    for n, m in tstate["opt"]["m"].items():
        _close(m, want_m[n], f"m {n}")


def _arch_in(monkeypatch, driver, dtype, **over):
    """Point ``driver``'s ``get_arch`` at qwen2-1.5b with its reduced
    config in ``dtype`` (and ``over``), set through the config as the
    reference's own tests set it."""
    arch = driver.get_arch("qwen2-1.5b")
    cfg, batch = arch.reduced()
    cfg = dataclasses.replace(cfg, dtype=dtype, **over)
    monkeypatch.setattr(driver, "get_arch", lambda _: dataclasses.replace(
        arch, reduced=lambda: (cfg, batch)))
    return cfg


def _both_drivers(tmp_path, monkeypatch, dtypes, steps, over=None,
                  **kw):
    """Run the reference's ``train_lm`` and the port's on reduced Qwen2
    in ``dtypes`` (JAX's, torch's), the port from the reference's draw;
    returns (the reference's ce, the port's ce, the port's state)."""
    drawn = {}
    init = JT.init_params

    def spy_init(cfg, key):
        params = init(cfg, key)       # donated to the first step: copied
        drawn["tree"] = jax.tree.map(lambda a: np.array(a, np.float32),
                                     params)
        return params

    over = over or {}
    _arch_in(monkeypatch, jlaunch, dtypes[0], **over)
    _arch_in(monkeypatch, tlaunch, dtypes[1], **over)
    monkeypatch.setattr(JT, "init_params", spy_init)
    _, jlosses = jlaunch.train_lm("qwen2-1.5b", steps=steps,
                                  ckpt_dir=str(tmp_path / "jax"), **kw)
    # the port's driver starts from the reference's draw
    monkeypatch.setattr(TT, "init_params", lambda cfg, gen: TT.lm_from_arrays(
        cfg, drawn["tree"], gen.device))
    state, losses = tlaunch.train_lm("qwen2-1.5b", steps=steps,
                                     ckpt_dir=str(tmp_path / "port"),
                                     device="cpu", **kw)
    assert len(losses) == len(jlosses) == steps
    return jlosses, losses, state


@pytest.mark.parametrize("attn_impl", [None, "flash"])
def test_train_lm_matches_reference(tmp_path, monkeypatch, attn_impl):
    """``train_lm`` on reduced Qwen2 in float32: the first three ce values
    equal the reference driver's within rtol 1e-4, from its weights."""
    jlosses, losses, state = _both_drivers(
        tmp_path, monkeypatch, (jnp.float32, torch.float32), 3,
        batch=4, seq=32, attn_impl=attn_impl)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert int(state["opt"]["step"]) == 3


def test_train_lm_draws_seed_zero_on_the_device(monkeypatch):
    """Without ``weights`` the LM is the seed-0 draw on the device, the
    same one ``init_params`` gives, and without a card the driver
    raises."""
    cfg = _arch_in(monkeypatch, tlaunch, torch.float32)
    steps = []
    state, losses = tlaunch.train_lm(
        "qwen2-1.5b", steps=1, batch=2, seq=16, ckpt_dir="unused",
        device="cpu", on_step=lambda n, m: steps.append((n, float(m["ce"]))))
    assert steps == [(1, losses[0])]
    lm = TT.init_params(cfg, torch.Generator("cpu").manual_seed(0))
    loss, _ = TT.loss_fn(cfg, lm, {k: torch.tensor(v) for k, v in
                                   lm_batch_fn(cfg.vocab, 2, 16)(0).items()})
    np.testing.assert_allclose(float(loss), losses[0], rtol=1e-6)
