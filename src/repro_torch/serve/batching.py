"""Continuous-batching decode pool (vLLM-style slot scheduler; the port of
``src/repro/serve/batching.py``).

A fixed pool of B decode slots over one shared KV cache; finished or empty
slots are refilled from the request queue between steps (a prefill writes
the new request's rows of the cache).  One decode step serves the whole
pool; per-slot positions, a device tensor, make the ragged decode exact.
The step runs every slot, idle ones included: an MoE LM routes all of
them, and its capacity is per call, so a pool's tokens depend on its slot
count (as the JAX package's pool's do) and are held to ``Generate``'s only
at the same batch.

With an engine, the prefill and the step run through ``engine.run_pinned``:
on the card each is one captured CUDA graph, replayed every call, and the
KV cache is the step's donated buffer, updated in place.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque

import numpy as np
import torch

from repro_torch.models import transformer_lm as tlm

#: monotonic pool ids that scope a pool's pinned programs (an id() would be
#: recycled)
_POOL_UID = itertools.count()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [P] int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Iteration-level decode pool.

    When an ``engine`` (a :class:`~repro_torch.core.engine
    .ShardedQueryEngine`) and a ``key`` are supplied, the prefill and
    decode-step bodies run through ``engine.run_pinned``, so the serving
    layer's recompiles-since-warmup invariant covers them: both have fixed
    shapes (prompt length and pool size are static), so a warmed server
    takes zero decode-path captures.  Without an engine both run eagerly.
    The pool lives on the LM's device.

    The programs' keys are ``(key, pool uid, "decode_step")`` and
    ``(key, pool uid, "decode_prefill")``: each pinned entry owns the KV
    cache it was first given (on the card, the captured graph's own
    buffer), so two pools, whose caches differ, never share an entry,
    whatever their ``key``."""

    def __init__(self, cfg: tlm.LMConfig, lm, *, slots: int = 4,
                 max_len: int = 256, eos_id: int | None = None,
                 engine=None, key=None):
        self.cfg = cfg
        self.lm = lm
        self.device = lm.embed.device
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache = tlm.init_kv_cache(cfg, slots, max_len,
                                       device=self.device)
        self.slot_req: list[Request | None] = [None] * slots
        # host copies of the slots' state, sent to the device each step
        self.positions = np.zeros(slots, np.int32)
        self.last_token = np.zeros((slots, 1), np.int32)
        self.queue: deque[Request] = deque()
        self.completed: list[Request] = []
        self.n_decode_steps = 0
        self.uid = next(_POOL_UID)

        # one ragged decode step for the whole pool
        def step(lm, tokens, cache, positions, active):
            logits, cache = tlm.decode_step_ragged(cfg, lm, tokens, cache,
                                                   positions)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            return torch.where(active, nxt, 0), cache

        def prefill_one(lm, tokens, cache, slot, length):
            return _slot_prefill(cfg, lm, tokens, cache, slot, length)

        if engine is not None:
            from repro_torch.core.engine import StageProgram
            step_prog = StageProgram(key=(key, self.uid, "decode_step"),
                                     fn=step)
            pre_prog = StageProgram(key=(key, self.uid, "decode_prefill"),
                                    fn=prefill_one)
            self._step = lambda *a: engine.run_pinned(
                step_prog, *a, donate_argnums=(2,))
            self._prefill = lambda *a: engine.run_pinned(
                pre_prog, *a, donate_argnums=(2,))
        else:
            self._step = torch.no_grad()(step)
            self._prefill = torch.no_grad()(prefill_one)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def submit(self, req: Request):
        self.queue.append(req)

    def free_slots(self) -> int:
        return sum(1 for r in self.slot_req if r is None)

    def active_slots(self) -> int:
        return self.slots - self.free_slots()

    def prefill_request(self, req: Request) -> int:
        """Place ``req`` into a free slot: prefill its prompt into the
        slot's KV-cache rows and record the first generated token.  The
        caller (the server's decode pump) owns admission policy; here we
        only require a free slot."""
        for s in range(self.slots):
            if self.slot_req[s] is None:
                break
        else:
            raise RuntimeError("prefill_request with no free slot")
        P = len(req.prompt)
        toks = self._dev(np.asarray(req.prompt, np.int32)[None, :])
        logits, self.cache = self._prefill(
            self.lm, toks, self.cache, self._dev(np.int32(s)),
            self._dev(np.int32(P)))
        first = int(torch.argmax(logits))
        req.generated.append(first)
        self.slot_req[s] = req
        self.positions[s] = P
        self.last_token[s, 0] = first
        return s

    def _admit(self):
        while self.queue and self.free_slots():
            self.prefill_request(self.queue.popleft())

    def step_active(self) -> list[Request]:
        """One decode step over the currently active slots (no admission).
        Returns the requests that finished on this step."""
        active = np.array([r is not None for r in self.slot_req])
        if not active.any():
            return []
        nxt, self.cache = self._step(
            self.lm, self._dev(self.last_token), self.cache,
            self._dev(self.positions), self._dev(active))
        self.n_decode_steps += 1
        nxt = nxt.cpu().numpy()
        finished: list[Request] = []
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(nxt[s])
            req.generated.append(tok)
            self.positions[s] += 1
            self.last_token[s, 0] = tok
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if (len(req.generated) >= req.max_new_tokens or hit_eos or
                    self.positions[s] >= self.max_len - 1):
                req.done = True
                self.completed.append(req)
                finished.append(req)
                self.slot_req[s] = None
        return finished

    def step(self):
        """Admit + one decode step for all active slots."""
        self._admit()
        return bool(self.step_active()) or any(
            r is not None for r in self.slot_req)

    def reset(self):
        """Forget all slot/queue state (the KV cache itself needs no
        clearing: the attention mask only reads positions a live request's
        prefill wrote).  Used after warmup's dummy prefill/decode."""
        self.slot_req = [None] * self.slots
        self.positions = np.zeros(self.slots, np.int32)
        self.last_token = np.zeros((self.slots, 1), np.int32)
        self.queue.clear()
        self.completed = []

    def run_to_completion(self, max_steps: int = 10000):
        steps = 0
        while (self.queue or any(self.slot_req)) and steps < max_steps:
            self.step()
            steps += 1
        return self.completed


def _slot_prefill(cfg, lm, tokens, cache, slot, length):
    """Prefill one slot's cache rows from a [1, P] prompt; ``slot`` is a
    device scalar, so the program is the same for every slot.  ``length``
    is the prompt's length, which the JAX package passes too and which the
    fixed prompt shape already gives."""
    at = slot.reshape(1).long()
    slot_cache = {"k": cache["k"].index_select(1, at),
                  "v": cache["v"].index_select(1, at)}
    logits, slot_cache = tlm.prefill(cfg, lm, tokens, slot_cache)
    cache["k"].index_copy_(1, at, slot_cache["k"])
    cache["v"].index_copy_(1, at, slot_cache["v"])
    return logits, cache
