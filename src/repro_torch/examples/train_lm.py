"""End-to-end LM training driver: trains a ~100M-param decoder-only LM
with the full substrate — deterministic data pipeline, AdamW + cosine
schedule, grad accumulation, async checkpointing, fault-tolerant
StepGuard (the port of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 10m \
        --steps 300 [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m \
        --steps 300

(The 100m preset is the deliverable configuration; 10m runs a quick
same-code demonstration on slow hosts.)  On the card ``attn_impl="flash"``
runs the flash kernel's forward (d_head 32 at 10m, 64 at 100m).
Checkpoints go under the checkout's ``build/`` unless ``--ckpt-dir``
names another directory.
"""
import argparse
import functools
import time
from pathlib import Path

import torch

from repro_torch.common import resolve_device
from repro_torch.models import transformer_lm as tlm
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts
from repro_torch.train.fault import StepGuard

PRESETS = {
    # ~110M params: 12L x 768, ff 2048, 32k vocab (tied)
    "100m": dict(n_layers=12, d_model=768, n_q=12, n_kv=4, d_head=64,
                 d_ff=2048, vocab=32768, batch=8, seq=256),
    # ~13M params: fast smoke-scale
    "10m": dict(n_layers=6, d_model=256, n_q=8, n_kv=4, d_head=32,
                d_ff=1024, vocab=8192, batch=8, seq=128),
}

#: the checkout's build directory (listed in .gitignore)
CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "lm_ckpt"


def run(preset: str = "10m", steps: int = 300, *,
        ckpt_dir: str = str(CKPT_DIR), attn_impl: str = "flash",
        device=None) -> list[float]:
    """Train the preset's LM from the seed-0 draw on ``device`` (``None``
    = the card) for ``steps`` steps; returns the ce of each step."""
    p = PRESETS[preset]
    cfg = tlm.LMConfig(
        name=f"lm-{preset}", n_layers=p["n_layers"], d_model=p["d_model"],
        n_q=p["n_q"], n_kv=p["n_kv"], d_head=p["d_head"], d_ff=p["d_ff"],
        vocab=p["vocab"], tie_embeddings=True, attn_impl=attn_impl)
    print(f"{cfg.name}: {cfg.params_total/1e6:.1f}M params")

    device = resolve_device(device)
    params = tlm.init_params(cfg, torch.Generator(device).manual_seed(0))
    state = ts.init_state(params)
    opt_cfg = opt_lib.AdamWConfig(lr=3e-3, warmup_steps=steps // 10,
                                  total_steps=steps)
    step_fn = ts.make_train_step(
        functools.partial(tlm.loss_fn, cfg), opt_cfg, n_micro=2)

    pipeline = data_lib.DataPipeline(
        data_lib.lm_batch_fn(cfg.vocab, p["batch"], p["seq"]))
    guard = StepGuard(ckpt_dir, ckpt_every=50)

    hist = []
    t0 = time.time()

    def logged(state, batch):
        s, m = step_fn(state, batch)
        hist.append(float(m["ce"]))
        if len(hist) % 20 == 0:
            print(f"step {len(hist):4d}  ce={hist[-1]:.4f}  "
                  f"({(time.time()-t0)/len(hist)*1000:.0f} ms/step)")
        return s, m

    state, _, step = guard.run(state, pipeline.iter_from, logged, steps)
    print(f"finished {step} steps: ce {hist[0]:.3f} -> {hist[-1]:.3f} "
          f"(min {min(hist):.3f})")
    return hist


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--attn-impl", default="flash")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda)")
    args = ap.parse_args()
    run(args.preset, args.steps, ckpt_dir=args.ckpt_dir,
        attn_impl=args.attn_impl, device=args.device)


if __name__ == "__main__":
    main()
