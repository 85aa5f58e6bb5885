"""The training step: loss -> grad -> clip -> AdamW -> metrics (counterpart of
``repro.training.train_step``).

Gradients are taken with ``torch.autograd.grad`` with respect to every
parameter leaf (the leaves require grad only while the loss and its
backward run), in the parameters' dtype: float32 for ``param_dtype
"float32"``.  The update is in place (the JAX launcher donates the
buffers).  Training runs ``attn_impl="ref"``: the kernels are forward only
and raise under grad, as the JAX package's Pallas kernels have no VJP.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.training import optimizer as opt
from repro_torch.training import tree


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    grad_clip: float = 1.0
    n_microbatches: int = 1   # gradient accumulation (bounds activation memory)


@contextlib.contextmanager
def _requiring_grad(leaves: list):
    for t in leaves:
        t.requires_grad_(True)
    try:
        yield
    finally:
        for t in leaves:
            t.requires_grad_(False)


def _grad_fn(cfg: ModelConfig, params, batch):
    """-> (loss, aux, grads): grads a tree of the params' structure, each leaf
    contiguous (a tied embedding's comes back transposed from the LM head)."""
    leaves = tree.leaves(params)
    with _requiring_grad(leaves), torch.enable_grad():
        loss, aux = registry.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    grads = tree.unflatten(params, [g.contiguous() for g in grads])
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def train_step(cfg: ModelConfig, tcfg: TrainConfig, params, opt_state, batch):
    """One optimizer step, updating ``params`` and ``opt_state`` in place ->
    (params, opt_state, metrics).

    With n_microbatches > 1 the global batch is split along dim 0 and float32
    grads are accumulated over the microbatches, the loss averaged over
    them (as the JAX package's ``lax.scan``; its metrics then carry no aux).
    """
    n = tcfg.n_microbatches
    if n <= 1:
        loss, aux, grads = _grad_fn(cfg, params, batch)
    else:
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split into {n} microbatches")
        m = rows // n
        grads = loss = None            # the JAX package's zero accumulators, plus the first
        for i in range(n):
            mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            l, _, g = _grad_fn(cfg, params, mb)
            if grads is None:
                grads, loss = tree.map_(lambda t: t.float(), g), l
            else:
                for acc, gi in tree.zip_leaves(grads, g):
                    acc.add_(gi.float())
                loss = loss + l
        grads = tree.map_(lambda t: t.div_(n), grads)
        loss = loss / n
        aux = {}

    grads, gnorm = opt.clip_by_global_norm(grads, tcfg.grad_clip)
    params, opt_state, lr = opt.adamw_update(tcfg.adamw, grads, params, opt_state)
    metrics = {"loss": loss.float(), "grad_norm": gnorm, "lr": lr}
    for k, v in aux.items():
        metrics[f"aux/{k}"] = v.float()
    return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, tcfg: Optional[TrainConfig] = None):
    tcfg = tcfg or TrainConfig()

    def step(params, opt_state, batch):
        return train_step(cfg, tcfg, params, opt_state, batch)

    return step
