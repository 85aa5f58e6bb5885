"""AdamW from scratch (counterpart of ``repro.training.optimizer``).

Moments are float32 trees of the parameters' structure, and the step count
a 0-dim int32 tensor; the learning rate and bias corrections stay on the
device, so an update needs no host sync.  The arithmetic is the JAX
package's, in its order, but ``adamw_update`` and ``clip_by_global_norm``
work in place, leaf by leaf and ``UPDATE_CHUNK`` elements at a time: the
temporaries are a few chunks, whatever the model's size (gemma3-4b's
parameters, grads and moments are 15.5 GB each in float32).

``opt_specs`` gives the moments' logical spec tree, ZeRO-1 style: on top of
the parameter's own sharding, each moment is sharded along the data axis
("opt_state") on its first unsharded dimension that divides evenly.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.distributed.sharding import is_dtensor, mesh_axis_size, tree_map_specs
from repro_torch.training import tree

#: elements updated a pass (64 MB of float32 per temporary)
UPDATE_CHUNK = 1 << 24


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def adamw_init(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step_device = tree.leaves(params)[0].device
    return {"m": tree.map_(zeros, params), "v": tree.map_(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_device)}


def _moment_spec(param_spec: Optional[tuple], shape: tuple) -> tuple:
    """Add 'opt_state' (data-axis) sharding on the first free, divisible dim."""
    if param_spec is None:
        param_spec = (None,) * len(shape)
    n = mesh_axis_size("opt_state")
    out = list(param_spec)
    # if the param is already FSDP-sharded over data, moments follow it as-is
    if n > 1 and "fsdp" not in param_spec and "opt_state" not in param_spec:
        for i, (ax, dim) in enumerate(zip(param_spec, shape)):
            if ax is None and dim % n == 0 and dim >= n:
                out[i] = "opt_state"
                break
    return tuple(out)


def opt_specs(param_spec_tree, param_shape_tree) -> dict:
    """Logical spec tree for the optimizer state (same structure as params);
    ``param_shape_tree`` holds a tensor (``device="meta"`` will do) or a
    shape at each leaf."""
    mspec = tree_map_specs(lambda sp, sh: _moment_spec(sp, tuple(getattr(sh, "shape", sh))),
                           param_spec_tree, param_shape_tree)
    return {"m": mspec, "v": mspec, "step": None}


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac (float32, on step's device)."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac
                    + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _pieces(t: torch.Tensor):
    # a view of a contiguous leaf (view raises on any other, where a reshape
    # would copy and lose the in-place update).  A DTensor leaf is one piece:
    # a rank updates its own shard, and flattening a sharded leaf into
    # pieces would cut its shards apart.
    if is_dtensor(t):
        return (t,)
    return t.view(-1).split(UPDATE_CHUNK)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, params, state):
    """-> (params, state, lr), both updated in place.  Decoupled weight decay;
    bias-corrected."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for leaf in tree.zip_leaves(grads, params, state["m"], state["v"]):
        for g, p, m, v in zip(*map(_pieces, leaf)):
            g = g.float()
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
            denom = torch.div(v, b2c).sqrt_().add_(cfg.eps)
            delta = torch.div(m, b1c).div_(denom)
            delta.add_(torch.mul(p.float(), cfg.weight_decay, out=denom))
            delta = delta.to(p.dtype).float().mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(delta)
            else:
                p.copy_(p.float().sub_(delta))
    return params, {"m": state["m"], "v": state["v"], "step": step}, lr


@torch.no_grad()
def global_norm(t) -> torch.Tensor:
    leaves = tree.leaves(t)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        for piece in _pieces(leaf):
            total = total + torch.sum(torch.square(piece.float()))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(t, max_norm: float):
    """Scale the leaves of ``t`` in place so that their global norm is at most
    ``max_norm`` -> (t, the norm before)."""
    norm = global_norm(t)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for leaf in tree.leaves(t):
        if leaf.dtype == torch.float32:
            leaf.mul_(scale)
        else:
            leaf.copy_(leaf.float() * scale)
    return t, norm
