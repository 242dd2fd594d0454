"""Serving driver: continuous-batching decode over an arch's reduced LM
(the port of ``src/repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 8 --max-new 12 [--device cpu]

The weights are a draw from a generator seeded ``seed`` and the prompts
the reference's, from ``np.random.default_rng(seed)``; the pool runs on
the card unless ``device`` says otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs.registry import get_arch
from repro_torch.models import transformer_lm as tlm
from repro_torch.serve.batching import ContinuousBatcher, Request


def serve_demo(arch_id: str, *, n_requests: int = 8, max_new: int = 12,
               slots: int = 4, max_len: int = 128, seed: int = 0,
               device=None):
    arch = get_arch(arch_id)
    cfg, _ = arch.reduced()
    device = resolve_device(device)
    lm = tlm.init_params(cfg, torch.Generator(device).manual_seed(seed))
    batcher = ContinuousBatcher(cfg, lm, slots=slots, max_len=max_len)

    rng = np.random.default_rng(seed)
    t0 = time.time()
    for rid in range(n_requests):
        plen = int(rng.integers(4, 16))
        prompt = rng.integers(0, cfg.vocab, plen, dtype=np.int32)
        batcher.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))
    done = batcher.run_to_completion()
    dt = time.time() - t0
    total_tokens = sum(len(r.generated) for r in done)
    print(f"served {len(done)}/{n_requests} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s incl. warm-up)")
    for r in done[:4]:
        print(f"  rid={r.rid} prompt_len={len(r.prompt)} -> {r.generated}")
    return done


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda)")
    args = ap.parse_args()
    serve_demo(args.arch, n_requests=args.requests, max_new=args.max_new,
               slots=args.slots, device=args.device)


if __name__ == "__main__":
    main()
