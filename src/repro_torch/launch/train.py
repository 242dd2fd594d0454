"""End-to-end training driver (the port of ``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 50 --batch 8 --seq 64 [--ckpt-dir build/ckpt] [--device cpu]

Wires the full substrate: config registry -> train state -> deterministic
data pipeline -> StepGuard (checkpoint/restore/replay) -> AdamW train step.
It trains the arch's smoke-scale config (``reduced``, the default) or its
full config, on the card unless ``device`` says otherwise.  Checkpoints
go to ``build/ckpt`` in the checkout unless ``--ckpt-dir`` names another
directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from pathlib import Path
from typing import Callable

import torch

from repro_torch.common import resolve_device
from repro_torch.configs.registry import get_arch
from repro_torch.models import transformer_lm as tlm
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts
from repro_torch.train.fault import StepGuard

#: the checkout's build directory (listed in .gitignore)
CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "ckpt"


def train_lm(arch_id: str, *, steps: int, batch: int, seq: int,
             ckpt_dir: str, reduced: bool = True, lr: float = 3e-3,
             ckpt_every: int = 20, log_every: int = 10,
             attn_impl: str | None = None, n_micro: int = 1,
             on_step: Callable[[int, dict], None] | None = None,
             device=None):
    """Train ``arch_id`` from the seed-0 draw for ``steps`` steps; returns
    (state, the ce of each step).  ``on_step(n, metrics)`` is called
    after each step."""
    arch = get_arch(arch_id)
    cfg = arch.reduced()[0] if reduced else arch.model_cfg("train_4k")
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    device = resolve_device(device)

    lm = tlm.init_params(cfg, torch.Generator(device).manual_seed(0))
    state = ts.init_state(lm)
    opt_cfg = opt_lib.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                                  total_steps=steps)
    step_fn = ts.make_train_step(functools.partial(tlm.loss_fn, cfg),
                                 opt_cfg, n_micro=n_micro)

    pipeline = data_lib.DataPipeline(
        data_lib.lm_batch_fn(cfg.vocab, batch, seq))
    guard = StepGuard(ckpt_dir, ckpt_every=ckpt_every)

    losses = []
    t0 = time.time()

    def logged_step(state, batch):
        new_state, metrics = step_fn(state, batch)
        losses.append(float(metrics["ce"]))
        n = len(losses)
        if on_step is not None:
            on_step(n, metrics)
        if n % log_every == 0:
            dt = (time.time() - t0) / n
            print(f"step {n:5d} ce={losses[-1]:.4f} "
                  f"({dt*1000:.0f} ms/step)")
        return new_state, metrics

    state, metrics, step = guard.run(
        state, pipeline.iter_from, logged_step, steps)
    print(f"done at step {step}: first ce={losses[0]:.4f} "
          f"last ce={losses[-1]:.4f}")
    return state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config (default: its reduced one)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda)")
    args = ap.parse_args()
    train_lm(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
             ckpt_dir=args.ckpt_dir, reduced=not args.full, lr=args.lr,
             attn_impl=args.attn_impl, n_micro=args.n_micro,
             device=args.device)


if __name__ == "__main__":
    main()
