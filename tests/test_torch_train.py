"""The port's training substrate against the JAX package on the CPU: the
flash training path (``flash_attention_xla``, an ``autograd.Function``) and
its guard, AdamW and its schedules, every case of tests/test_train_infra.py
on the port, checkpoints read both ways, and the arch registry.

Inputs are drawn by numpy from a seed and fed to both sides.  The flash
path's output and its (dq, dk, dv) agree with ``jax.vjp`` of the
reference's ``flash_attention_xla`` within 1e-5 (the tolerance of
tests/test_kernels.py::test_flash_vjp_matches_naive_grads)."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.configs import qwen2_1_5b as jqwen
from repro.configs import registry as jregistry
from repro.kernels.flash_attention import ops as jops
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import registry as tregistry
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.models import transformer_lm as TT
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression, data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts
from repro_torch.train.fault import ElasticMesh, StepGuard, \
    StragglerMonitor, feasible_mesh_shape

from test_torch_generate import _carry, _port_cfg

# ---------------------------------------------------------------------------
# flash_attention_xla and the kernel entry's guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,bq", [(64, 64), (96, 64)])
@pytest.mark.parametrize("chunk", [0, 16, 32])
@pytest.mark.parametrize("H,HKV", [(4, 2), (4, 4)])
def test_flash_xla_matches_reference_vjp(H, HKV, chunk, S, bq):
    """Output and gradients against the reference's custom VJP; S 96 with
    bq 64 makes the block halve to 32 on both sides."""
    rng = np.random.default_rng(H * 100 + HKV * 10 + chunk + S)
    B, D = 2, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda q_, k_, v_: jops.flash_attention_xla(
        q_, k_, v_, causal=True, chunk=chunk, bq=bq), *map(jnp.asarray,
                                                          (q, k, v)))
    wants = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = tops.flash_attention_xla(tq, tk, tv, causal=True, chunk=chunk,
                                   bq=bq)
    assert got.grad_fn is not None
    gots = torch.autograd.grad(got, (tq, tk, tv), torch.tensor(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    for name, g, w in zip("qkv", gots, wants):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=f"d{name}")


def test_flash_xla_keeps_the_input_dtype():
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.standard_normal((1, 32, 4, 16)),
                     dtype=torch.bfloat16, requires_grad=True)
    k = torch.tensor(rng.standard_normal((1, 32, 2, 16)),
                     dtype=torch.bfloat16, requires_grad=True)
    o = tops.flash_attention_xla(q, k, k)
    assert o.dtype == torch.bfloat16
    dq, dk = torch.autograd.grad(o.float().square().sum(), (q, k))
    assert dq.dtype == dk.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="H % Hkv"):
        tops.flash_attention_xla(q, k[:, :, :1].expand(1, 32, 3, 16), k)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so the wrapper takes
    its kernel branch up to the point where it would launch."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_kernel_entry_raises_under_grad(which):
    """The kernel's output has no grad_fn: on a card tensor that requires
    grad, ``flash_attention`` raises before any launch and names the
    training path; under no_grad it goes on to its other checks."""
    t = {n: torch.zeros((1, 8, 2 if n == "q" else 1, 16)) for n in "qkv"}
    t[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match='attn_impl="flash"'):
        tops.check_no_grad(t["q"], t["k"], t["v"])
    card = {n: x.as_subclass(_OnCard) for n, x in t.items()}
    assert card[which].requires_grad
    with pytest.raises(RuntimeError, match='attn_impl="flash"'):
        tops.flash_attention(card["q"], card["k"], card["v"])
    with torch.no_grad(), pytest.raises(ValueError, match="d_head=16"):
        tops.flash_attention(card["q"], card["k"], card["v"])
    assert tops.flash_attention.launches == 0
    # the CPU path is the differentiable plain version
    out = tops.flash_attention(t["q"], t["k"], t["v"])
    assert out.grad_fn is not None


@pytest.mark.parametrize("D,dtype", [(32, torch.float32), (32, torch.bfloat16),
                                     (64, torch.bfloat16),
                                     (128, torch.float32)])
def test_kernel_entry_takes_d_head_32(monkeypatch, D, dtype):
    """On a card tensor a head of 32 reaches the C entry as it is in fp32
    (the CUDA-core kernel takes 32) and zero-padded to 64 in bf16 (the
    wgmma kernel's narrowest tile), with the scale of 32 either way, and
    the output comes back at 32; 64 and 128 pass as they are.  No launch
    happens here: the library is a stand-in that records its arguments."""
    calls = []

    class Library:
        def repro_flash_attention(self, q, k, v, out, B, S, T, H, HKV, d,
                                  causal, chunk, is_bf16, scale, stream):
            calls.append((d, is_bf16, scale))
            return 0

    monkeypatch.setattr(tops._build, "library", Library)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(tops.flash_attention, "launches", 0)
    q, k, v = (torch.zeros((2, 8, h, D), dtype=dtype).as_subclass(_OnCard)
               for h in (4, 2, 2))
    with torch.no_grad():
        out = tops.flash_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == dtype
    padded = D == 32 and dtype == torch.bfloat16
    assert calls == [(64 if padded else D, int(dtype == torch.bfloat16),
                      D ** -0.5)]
    assert tops.flash_attention.launches == 1
    assert tops.KERNEL_D_HEADS == (32, 64, 128)
    for bad in (16, 48, 96):
        q, k, v = (torch.zeros((2, 8, h, bad), dtype=dtype)
                   .as_subclass(_OnCard) for h in (4, 2, 2))
        with torch.no_grad(), pytest.raises(ValueError,
                                            match=f"d_head={bad}"):
            tops.flash_attention(q, k, v)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_reference(schedule):
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, schedule=schedule)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), opt_lib.AdamWConfig(**cfg)
    for step in (0, 1, 5, 10, 37, 100, 150):
        want = float(jopt.schedule_lr(jcfg, jnp.int32(step)))
        got = opt_lib.schedule_lr(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {step}")


class _StackedTree(nn.Module):
    """A 2-D leaf ``w``, a 1-D ``b`` and two layers' 1-D ``ln``, which the
    module declares stacked as ``TransformerLM`` declares its layers."""

    stacked_prefixes = ("layers.",)

    def __init__(self, w, b, ln, dtype):
        super().__init__()

        def param(a):
            return nn.Parameter(torch.tensor(a).to(dtype),
                                requires_grad=False)

        self.w, self.b = param(w), param(b)
        self.layers = nn.ModuleList()
        for row in ln:
            layer = nn.Module()
            layer.ln = param(row)
            self.layers.append(layer)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Three updates of a module with 2-D and 1-D leaves and two layers'
    1-D leaves, which it declares stacked as the reference stacks them
    into one [2, d] leaf: weight
    decay takes the 2-D ones and the stacked ones, as the reference does.
    bf16 parameters keep fp32 moments and round once per update (within
    one bf16 step of the reference)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ln = rng.standard_normal((2, 5)).astype(np.float32)
    jp = {"w": jnp.asarray(w, jdt), "b": jnp.asarray(b, jdt),
          "layers": {"ln": jnp.asarray(ln, jdt)}}
    tp = _StackedTree(w, b, ln, tdt)
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=10, grad_clip=1.0,
               weight_decay=0.1)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), opt_lib.AdamWConfig(**cfg)
    js, tstate = jopt.init(jp), opt_lib.init(tp)
    for _ in range(3):
        gw, gb, gl = (rng.standard_normal(a.shape).astype(np.float32)
                      for a in (w, b, ln))
        jg = {"w": jnp.asarray(gw, jdt), "b": jnp.asarray(gb, jdt),
              "layers": {"ln": jnp.asarray(gl, jdt)}}
        tg = {"w": torch.tensor(gw).to(tdt), "b": torch.tensor(gb).to(tdt),
              **{f"layers.{i}.ln": torch.tensor(gl[i]).to(tdt)
                 for i in range(2)}}
        jp, js, jm = jopt.update(jcfg, jg, js, jp)
        tp, tstate, tm = opt_lib.update(tcfg, tg, tstate, tp)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
    assert int(tstate["step"]) == int(js["step"]) == 3
    got = {"w": tp.w, "b": tp.b,
           "ln": torch.stack([tp.layers[i].ln for i in range(2)])}
    want = {"w": jp["w"], "b": jp["b"], "ln": jp["layers"]["ln"]}
    for name in got:
        assert got[name].dtype == tdt
        g = got[name].float().numpy()
        wnt = np.asarray(want[name], np.float32)
        tol = 1e-6 if dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(g, wnt, rtol=tol, atol=1e-7,
                                   err_msg=name)
    for name, key in (("w", "w"), ("b", "b")):
        np.testing.assert_allclose(tstate["m"][name].numpy(),
                                   np.asarray(js["m"][key]), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(tstate["v"][name].numpy(),
                                   np.asarray(js["v"][key]), rtol=1e-5,
                                   atol=1e-9)
    assert tstate["m"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# tests/test_train_infra.py on the port
# ---------------------------------------------------------------------------


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.float32)}}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _leaves(tree):
    return list(opt_lib.named_leaves(tree).values())


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 3, t)
    out = ckpt.restore(tmp_path, 3, _zeros_like(t))
    for a, b in zip(_leaves(t), _leaves(out)):
        assert torch.equal(a, b)
    assert ckpt.latest_step(tmp_path) == 3


def test_checkpoint_detects_corruption(tmp_path):
    t = _tree()
    d = ckpt.save(tmp_path, 1, t)
    target = next(d.glob("a.npy"))
    raw = bytearray(target.read_bytes())
    raw[-1] ^= 0xFF
    target.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(tmp_path, 1, t)


def test_async_checkpointer_gc(tmp_path):
    c = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    for s in [1, 2, 3, 4]:
        c.save_async(s, _tree())
    c.wait()
    steps = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]


def test_stepguard_replays_after_failure(tmp_path):
    """Inject a failure mid-run; the guard must restore and replay the SAME
    batches (determinism contract)."""
    state = {"x": torch.zeros(()), "seen": torch.zeros((), dtype=torch.int32)}
    pipeline = data_lib.DataPipeline(
        lambda step, shard=0, n=1: {"v": np.float32(step)})
    fail_at = {"n": 7, "armed": True}

    def step_fn(state, batch):
        if fail_at["armed"] and float(batch["v"]) == fail_at["n"]:
            fail_at["armed"] = False
            raise RuntimeError("injected node failure")
        return ({"x": state["x"] + float(batch["v"]),
                 "seen": state["seen"] + 1}, {"v": batch["v"]})

    guard = StepGuard(tmp_path, ckpt_every=2, max_retries=2)
    state, _, step = guard.run(state, pipeline.iter_from, step_fn, 10)
    assert step == 10
    assert guard.replays == 1
    assert float(state["x"]) == sum(range(10))
    assert int(state["seen"]) == 10


def test_straggler_monitor_flags_slow_host():
    mon = StragglerMonitor(4, threshold=1.5, grace_steps=3)
    for _ in range(5):
        flagged = mon.record(np.array([1.0, 1.0, 1.0, 2.5]))
    assert flagged == [3]
    mon2 = StragglerMonitor(2, threshold=1.5, grace_steps=3)
    mon2.record(np.array([1.0, 2.5]))
    mon2.record(np.array([1.0, 1.0]))
    assert mon2.strikes[1] == 0


def test_elastic_mesh_plan():
    em = ElasticMesh(model_degree=16)
    plan = em.rescale_plan(old_data_degree=16, new_data_degree=12,
                           global_batch=256, n_micro=4)
    assert plan["achieved_global_batch"] >= 256
    assert plan["per_shard_batch"] % plan["n_micro"] == 0
    assert plan["n_micro"] >= 4
    plan2 = em.rescale_plan(16, 8, 256, 4)
    assert plan2["achieved_global_batch"] == 256
    assert feasible_mesh_shape(255, 16) == (15, 16)
    with pytest.raises(RuntimeError):
        feasible_mesh_shape(15, 16)
    grid = ElasticMesh(model_degree=2).build([torch.device("cpu")] * 5)
    assert grid.shape == (2, 2) and grid[1, 1] == torch.device("cpu")


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compression_error_feedback_converges(scheme):
    """With error feedback, the accumulated compressed signal tracks the true
    gradient sum (unbiasedness over time)."""
    ef = compression.ErrorFeedback(scheme, k_frac=0.25)
    g = {"w": torch.tensor(np.random.default_rng(0)
                           .standard_normal(64).astype(np.float32))}
    res = ef.init(g)
    total_out = torch.zeros(64)
    for _ in range(30):
        out, res = ef.compress_decompress(g, res)
        total_out = total_out + out["w"]
    err = float((total_out / 30 - g["w"]).abs().max())
    assert err < (0.05 if scheme == "int8" else 0.15)
    comp, raw = ef.wire_bytes(g)
    assert comp < raw


def test_adamw_descends_quadratic():
    cfg = opt_lib.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                              total_steps=100, schedule="constant")
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt_lib.init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, m = opt_lib.update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 0.5
    assert int(state["step"]) == 60


def test_data_pipeline_deterministic_replay():
    fn = data_lib.lm_batch_fn(vocab=100, batch=4, seq=8)
    p = data_lib.DataPipeline(fn)
    a = next(p.iter_from(5))
    b = next(p.iter_from(5))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compression_matches_reference(scheme):
    """One round of each scheme equals the reference's (top-k ties to the
    lowest index, as ``lax.top_k``)."""
    from repro.train import compression as jcomp
    rng = np.random.default_rng(1)
    g = rng.standard_normal(40).astype(np.float32)
    g[[3, 9]] = g[5]                       # a tie at the cut
    e = rng.standard_normal(40).astype(np.float32) * 0.1
    jout, jres = jcomp.ErrorFeedback(scheme, 0.1).compress_decompress(
        {"w": jnp.asarray(g)}, {"w": jnp.asarray(e)})
    tout, tres = compression.ErrorFeedback(scheme, 0.1).compress_decompress(
        {"w": torch.tensor(g)}, {"w": torch.tensor(e)})
    np.testing.assert_allclose(tout["w"].numpy(), np.asarray(jout["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tres["w"].numpy(), np.asarray(jres["w"]),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# checkpoints both ways
# ---------------------------------------------------------------------------


def _jax_state(dtype, step):
    """A reduced Qwen2's JAX train state with nonzero moments."""
    jcfg = dataclasses.replace(jqwen.reduced()[0], dtype=dtype)
    params, lm = _carry(jcfg)
    state = jts.init_state(params)
    rng = np.random.default_rng(7)
    noise = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), state["opt"]["m"])
    state["opt"] = {"m": noise, "v": jax.tree.map(jnp.square, noise),
                    "step": jnp.asarray(step, jnp.int32)}
    return jcfg, state


def _by_name(tree, prefix=""):
    """A JAX LM tree by the port's parameter names (layers unstacked)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if k == "layers":
                for name, a in _by_name(v).items():
                    for i in range(a.shape[0]):
                        out[f"{prefix}layers.{i}.{name}"] = a[i]
            else:
                out.update(_by_name(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def test_port_restores_a_jax_checkpoint_with_bf16_leaves(tmp_path):
    """JAX writes bf16 parameters, fp32 moments and an int32 step; the port
    reads them (bf16 through raw words) into its LM and optimizer state,
    bit for bit, and its own save of that state writes the same files."""
    jcfg, jstate = _jax_state(jnp.bfloat16, 7)
    jdir = jckpt.save(tmp_path / "jax", 7, jstate)
    man = json.loads((jdir / "manifest.json").read_text())
    assert man["leaves"]["params/embed"]["dtype"] == "bfloat16"
    lm = TT.TransformerLM(_port_cfg(jcfg), device="cpu")
    state = ts.init_state(lm)
    ckpt.restore(tmp_path / "jax", 7, state)
    assert int(state["opt"]["step"]) == 7
    assert state["opt"]["step"].dtype == torch.int32
    assert lm.embed.dtype == torch.bfloat16
    want = _by_name(jstate["params"])
    got = {n: p.detach().float().numpy() for n, p in lm.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    for mom in ("m", "v"):
        w = _by_name(jstate["opt"][mom])
        for n in w:
            np.testing.assert_array_equal(state["opt"][mom][n].numpy(), w[n])
    pdir = ckpt.save(tmp_path / "port", 7, state)
    pman = json.loads((pdir / "manifest.json").read_text())
    assert pman == man
    for meta in man["leaves"].values():
        assert (pdir / meta["file"]).read_bytes() == \
            (jdir / meta["file"]).read_bytes(), meta["file"]


def test_jax_restores_a_port_checkpoint(tmp_path):
    """The port writes a float32 LM's train state; the reference restores
    it into its own state tree, leaf for leaf.  (The reference cannot
    restore bf16 leaves, its own included: ``np.load`` gives raw ``|V2``
    words, which ``jnp.asarray`` refuses; the previous test holds the
    port's bf16 files byte-equal to the reference's.)"""
    jcfg, jstate = _jax_state(jnp.float32, 3)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jstate["params"])
    lm = TT.lm_from_arrays(_port_cfg(jcfg), tree, "cpu")
    state = ts.init_state(lm)
    rng = np.random.default_rng(8)
    for mom in ("m", "v"):
        for t in state["opt"][mom].values():
            t.copy_(torch.tensor(rng.standard_normal(t.shape)))
    state["opt"]["step"].fill_(3)
    ckpt.save(tmp_path, 3, state)
    target = jax.tree.map(jnp.zeros_like, jstate)
    out = jckpt.restore(tmp_path, 3, target)
    assert int(out["opt"]["step"]) == 3
    for n, a in _by_name(out["params"]).items():
        np.testing.assert_array_equal(
            a, dict(lm.named_parameters())[n].detach().numpy(), err_msg=n)
    for mom in ("m", "v"):
        for n, a in _by_name(out["opt"][mom]).items():
            np.testing.assert_array_equal(a, state["opt"][mom][n].numpy())


def test_lm_to_arrays_inverts_lm_from_arrays():
    from repro.configs import llama4_scout_17b_a16e as jl4
    jcfg = dataclasses.replace(jl4.reduced()[0], dtype=jnp.float32,
                               n_layers=3)
    params, lm = _carry(jcfg)
    back = TT.lm_to_arrays(_port_cfg(jcfg), lm)
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_want) == len(flat_got)
    for path, a in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(a))


# ---------------------------------------------------------------------------
# the arch registry
# ---------------------------------------------------------------------------


LM_ARCHS = ["qwen2-1.5b", "glm4-9b", "internlm2-1.8b",
            "llama4-scout-17b-a16e", "olmoe-1b-7b"]


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_registry_lm_archs_match_reference(arch_id):
    ja, ta = jregistry.get_arch(arch_id), tregistry.get_arch(arch_id)
    assert ta.shapes == ja.shapes
    for make in ("model_cfg", "reduced"):
        jc = ja.model_cfg("train_4k") if make == "model_cfg" \
            else ja.reduced()[0]
        tc = ta.model_cfg("train_4k") if make == "model_cfg" \
            else ta.reduced()[0]
        want = dataclasses.replace(_port_cfg(jc), dtype=tc.dtype)
        assert tc == want, make
    np.testing.assert_array_equal(ta.reduced()[1]()["tokens"],
                                  ja.reduced()[1]()["tokens"])


def test_registry_zoo_archs_raise():
    """The zoo's archs no longer raise (ROADMAP §1 item 3 is ported): the
    registry resolves the reference's ten, and only an unknown id
    raises."""
    assert tregistry.all_arch_ids() == jregistry.all_arch_ids()
    zoo = set(jregistry.all_arch_ids()) - set(LM_ARCHS)
    assert zoo == {"gat-cora", "dcn-v2", "dien", "mind", "autoint"}
    for arch_id in zoo:
        assert tregistry.get_arch(arch_id).family == \
            jregistry.get_arch(arch_id).family
    with pytest.raises(KeyError, match="unknown architecture"):
        tregistry.get_arch("gpt-9")
