"""The hook through which a cost model prices a kernel call.

A cost counter (``analysis/op_cost.py``'s ``OpCounter``) enters
:func:`counting` for the span of one pricing run.  While it is there, a
kernel entry wrapped by :func:`priced` computes nothing: it charges the
counter its kernel's formula — inputs read once, outputs written once, its
arithmetic — and returns zero outputs of the shapes and dtypes the kernel
would return, on the inputs' device.  So a pricing run launches no kernel
and runs no plain version, on the card or on the CPU, and both price a
program alike.  Outside a pricing run the entry is the wrapper as written.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

_LOCAL = threading.local()


def active():
    """The innermost counter of this thread's pricing runs, or None."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def counting(counter):
    """Price kernel calls on this thread into ``counter`` (an object with
    ``charge(flops, bytes)`` and a ``pause()`` context) for the block."""
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    stack.append(counter)
    try:
        yield counter
    finally:
        stack.pop()


def priced(cost, outputs):
    """Decorator of a kernel's public entry.  Under :func:`counting` the
    call charges ``cost(*args, **kwargs) -> (flops, bytes)`` and returns
    ``outputs(*args, **kwargs)``, zero tensors of the kernel's output
    shapes, made with counting paused; otherwise it runs as written."""
    def deco(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            counter = active()
            if counter is None:
                return fn(*args, **kwargs)
            counter.charge(*cost(*args, **kwargs))
            with counter.pause():
                return outputs(*args, **kwargs)
        return entry
    return deco


def topk_outputs(lead: tuple, k: int, n: int, device):
    """Zero (values f32, indices int32) of shape ``lead + (k,)``; raises
    for a k outside [1, n], as the kernels do."""
    if not 0 < k <= n:
        raise ValueError(f"k={k} outside [1, {n}]")
    shape = (*lead, k)
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.int32, device=device))
