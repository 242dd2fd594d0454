"""The training recipe of ``launch.train.train_lm`` (AdamW at its default
lr 3e-3, warm-up 1 step, cosine) on the port and the JAX package, both
drivers on the CPU from the reference's draw, over 11 steps: in bfloat16
on reduced Qwen2, and at Qwen2's published d_model and heads (d_model
1536, 12/2 heads of 128; depth, d_ff and vocab cut), where tied N(0, 1)
embeddings give logits of RMS ~sqrt(1536) = 39 at the start, as at full
width.  There the reference's own ce rises above its start under this
recipe, and a bfloat16 run drifts from the float32 one by the rounding the
rise amplifies; the port is held to the reference's trajectory in float32
and, in bfloat16, to no more than the reference's own drift between the
two dtypes."""
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_train_lm import _both_drivers

STEPS = 11
RECIPE = dict(batch=4, seq=32, attn_impl="flash", lr=3e-3)
#: Qwen2-1.5B's d_model and heads, the rest cut to the reduced config's
WIDE = dict(d_model=1536, n_q=12, n_kv=2, d_head=128, d_ff=256)
F32, BF16 = (jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))


def test_bf16_reduced_matches_reference(tmp_path, monkeypatch):
    """Reduced Qwen2 in bfloat16: every step's ce within 1e-2 (relative)
    of the reference driver's."""
    jce, ce, _ = _both_drivers(tmp_path, monkeypatch, BF16, STEPS,
                               **RECIPE)
    assert np.all(np.isfinite(ce))
    np.testing.assert_allclose(ce, jce, rtol=1e-2)


def test_rise_at_qwen2_width_is_the_reference_s(tmp_path, monkeypatch):
    """At d_model 1536 the reference's ce rises above its start in both
    dtypes, the port's float32 ce is within 1e-2 of the reference's at
    every step, and the port's bfloat16 ce strays from the reference's
    bfloat16 ce by no more, on the mean over steps, than the reference's
    bfloat16 ce strays from its float32 ce."""
    runs = {}
    for name, dtypes in (("f32", F32), ("bf16", BF16)):
        runs[name] = _both_drivers(tmp_path / name, monkeypatch, dtypes,
                                   STEPS, over=WIDE, **RECIPE)[:2]
    (jf, tf), (jb, tb) = runs["f32"], runs["bf16"]
    print(f"reference ce f32 {np.round(jf, 3).tolist()} "
          f"bf16 {np.round(jb, 3).tolist()}; port ce f32 "
          f"{np.round(tf, 3).tolist()} bf16 {np.round(tb, 3).tolist()}")
    for ce in (jf, tf, jb, tb):
        assert np.all(np.isfinite(ce)) and max(ce) > ce[0], ce
    np.testing.assert_allclose(tf, jf, rtol=1e-2)
    port_drift, own_drift = _rel(tb, jb).mean(), _rel(jb, jf).mean()
    assert port_drift <= own_drift, (port_drift, own_drift)
