"""The train step: gradient accumulation over micro-batches, then AdamW
(the port of ``src/repro/train/train_step.py``).

``make_train_step(loss_fn, opt_cfg, n_micro)`` builds
``train_step(state, batch) -> (state, metrics)``, where ``loss_fn(params,
batch) -> (loss, metrics)``.  The global batch's leading axis splits into
``n_micro`` micro-batches; their gradients are summed in fp32 and divided
by ``n_micro`` and their metrics averaged, as the JAX package's scan does.
The step updates the state's parameters and moments in place.

On a mesh (parameters that are a rank's shards, ``params.mesh``) the
batch holds the rank's rows, each micro-batch's share in turn
(``sharding.batch_share``, under ``transformer_lm.shard_batch`` and
``recsys/embedding.py::shard_batch``: micro-batch i is the global batch's
rows [i B/n, (i+1) B/n), as the reference splits it), and
``batch["rows"]`` the whole batch's row count; each micro-batch's loss
is told its own.  A GAT step takes its graph whole and cuts it inside
its loss (no ``"rows"``).  Every rank's loss is the whole micro-batch's,
so each backpropagates 1/(the ranks) of it: the collectives' backward
sums the ranks' shares (``collectives.py``), and the optimizer sums each
leaf's gradient over the ranks that hold it alike (``optimizer.update``).
The metrics are global.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.train import optimizer as opt_lib


def _split_micro(batch: dict, n_micro: int) -> dict:
    def r(x):
        assert x.shape[0] % n_micro == 0, (x.shape, n_micro)
        return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    return {k: r(v) for k, v in batch.items()}


def make_train_step(
    loss_fn: Callable[..., tuple[torch.Tensor, dict]],
    opt_cfg: opt_lib.AdamWConfig,
    *,
    n_micro: int = 1,
) -> Callable[[dict, dict], tuple[dict, dict]]:

    def train_step(state: dict[str, Any], batch: dict):
        params = state["params"]
        leaves = opt_lib.named_leaves(params)
        device = next(iter(leaves.values())).device
        mesh = getattr(params, "mesh", None)
        batch = dict(batch)
        rows = batch.pop("rows", None)
        micro = _split_micro({k: torch.as_tensor(v, device=device)
                              for k, v in batch.items()}, n_micro)
        grads, seq = None, []
        for i in range(n_micro):
            mb = {k: v[i] for k, v in micro.items()}
            if rows is not None:
                mb["rows"] = rows // n_micro
            loss, metrics = loss_fn(params, mb)
            if mesh is not None:
                loss = loss / mesh.size
            g = torch.autograd.grad(loss, list(leaves.values()))
            if grads is None:
                grads = [x.float() for x in g]
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x)
            seq.append({k: v.detach().float() for k, v in metrics.items()})
            del loss, metrics, g
        if n_micro > 1:
            for acc in grads:
                acc.div_(n_micro)
        metrics = {k: torch.stack([m[k] for m in seq]).mean(0)
                   for k in seq[0]}
        params, opt, opt_metrics = opt_lib.update(
            opt_cfg, dict(zip(leaves, grads)), state["opt"], params)
        return {"params": params, "opt": opt}, {**metrics, **opt_metrics}

    return train_step


def init_state(params: Any) -> dict[str, Any]:
    """The train state of ``params`` (an ``nn.Module`` or a dict tree),
    whose tensors it makes require grad: the models are made with
    ``requires_grad=False`` for serving."""
    for p in opt_lib.named_leaves(params).values():
        p.requires_grad_(True)
    return {"params": params, "opt": opt_lib.init(params)}
