"""Fault tolerance: elastic re-meshing, retry-with-restore, and straggler
mitigation (the port of ``src/repro/train/fault.py``).

* :class:`ElasticMesh` — the largest feasible (data, model) grid from the
  surviving devices (model degree preserved: TP groups are intact or
  dropped whole; DP degree shrinks), and the plan that keeps the global
  batch via more grad-accum microbatches.  torch has no single-process
  ``Mesh``: :meth:`ElasticMesh.build` returns the grid of
  ``torch.device``s.
* :class:`StepGuard` — wraps a train step: on exception (device loss,
  pre-emption) it restores the last good checkpoint and replays.
  Deterministic data order makes replay exact (see data.py).
* :class:`StragglerMonitor` — EMA of per-step host times; hosts slower than
  ``threshold``× the fleet median are flagged for re-dispatch/eviction,
  with hysteresis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.train import checkpoint as ckpt_lib


# ---------------------------------------------------------------------------
# elastic re-meshing
# ---------------------------------------------------------------------------

def feasible_mesh_shape(n_alive: int, model_degree: int,
                        min_data: int = 1) -> tuple[int, int]:
    """Largest (data, model) grid from ``n_alive`` devices keeping the model
    (TP) degree fixed — TP groups must stay whole."""
    data = n_alive // model_degree
    if data < min_data:
        raise RuntimeError(
            f"only {n_alive} devices alive; cannot keep model degree "
            f"{model_degree}")
    return (data, model_degree)


@dataclasses.dataclass
class ElasticMesh:
    model_degree: int
    axis_names: tuple[str, str] = ("data", "model")

    def build(self, devices: list | None = None) -> np.ndarray:
        """The (data, model) grid of ``devices`` (default: every card; it
        raises without CUDA) as an object array of ``torch.device``."""
        if devices is None:
            resolve_device(None)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        shape = feasible_mesh_shape(len(devices), self.model_degree)
        grid = np.empty(shape, dtype=object)
        grid.reshape(-1)[:] = devices[:shape[0] * shape[1]]
        return grid

    def rescale_plan(self, old_data_degree: int, new_data_degree: int,
                     global_batch: int, n_micro: int) -> dict:
        """Preserve the global batch (up to rounding) when DP shrinks by
        raising grad-accum; per-shard batch is padded to a microbatch
        multiple and the achieved batch reported."""
        scale = old_data_degree / new_data_degree
        new_micro = max(1, int(np.ceil(n_micro * scale)))
        per_shard = -(-global_batch // new_data_degree)      # ceil div
        per_shard = -(-per_shard // new_micro) * new_micro   # micro multiple
        return {"n_micro": new_micro,
                "per_shard_batch": per_shard,
                "achieved_global_batch": per_shard * new_data_degree}


# ---------------------------------------------------------------------------
# retry / restore guard
# ---------------------------------------------------------------------------

class StepGuard:
    """train loop wrapper: checkpoint every ``ckpt_every`` steps; on failure
    restore the last good state (into the state's tensors, in place) and
    replay."""

    def __init__(self, ckpt_dir, *, ckpt_every: int = 50, max_retries: int = 3,
                 on_failure: Callable[[Exception], None] | None = None):
        self.ckpt = ckpt_lib.AsyncCheckpointer(ckpt_dir)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.on_failure = on_failure
        self.retries = 0
        self.replays = 0

    def run(self, state, data_iter_factory, step_fn, n_steps: int,
            start_step: int = 0):
        """``data_iter_factory(step)`` -> iterator from that step (replay)."""
        step = start_step
        data_iter = data_iter_factory(step)
        metrics = None
        while step < n_steps:
            try:
                batch = next(data_iter)
                state, metrics = step_fn(state, batch)
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save_async(step, state)
            except Exception as e:  # noqa: BLE001 — node loss, OOM, ...
                self.retries += 1
                if self.on_failure:
                    self.on_failure(e)
                if self.retries > self.max_retries:
                    raise
                self.ckpt.wait()
                last = ckpt_lib.latest_step(self.ckpt_dir)
                if last is not None:
                    state = ckpt_lib.restore(self.ckpt_dir, last, state)
                    step = last
                data_iter = data_iter_factory(step)   # deterministic replay
                self.replays += 1
        self.ckpt.wait()
        return state, metrics, step


# ---------------------------------------------------------------------------
# straggler mitigation
# ---------------------------------------------------------------------------

class StragglerMonitor:
    def __init__(self, n_hosts: int, *, threshold: float = 1.5,
                 ema: float = 0.9, grace_steps: int = 5):
        self.times = np.zeros(n_hosts)
        self.strikes = np.zeros(n_hosts, np.int32)
        self.threshold = threshold
        self.ema = ema
        self.grace = grace_steps

    def record(self, host_times: np.ndarray) -> list[int]:
        """Feed per-host step durations; returns hosts to re-dispatch."""
        self.times = np.where(self.times == 0, host_times,
                              self.ema * self.times + (1 - self.ema) * host_times)
        med = np.median(self.times)
        slow = self.times > self.threshold * med
        self.strikes = np.where(slow, self.strikes + 1, 0)
        return np.nonzero(self.strikes >= self.grace)[0].tolist()
