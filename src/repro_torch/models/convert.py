"""Carry the JAX package's parameters across into the port's layout.

``params_from_jax(cfg, tree)`` takes the JAX parameter pytree after
``jax.tree.map(np.asarray, params)`` (nested dicts/lists of numpy arrays) and
returns the port's ``{"head": ..., "layers": [...]}``.  The JAX tree stacks
its layers by run (``stack.compute_runs``): ``tree["runs"][i][j]`` holds
sub-layer j of run i, with a leading axis of ``run.count`` when the run
repeats.  Layer order is run by run, repetition by repetition, sub-layer by
sub-layer.  This module needs no jax: it reads numpy arrays only.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import stack


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy array (ml_dtypes bfloat16 included) -> tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(cfg: ModelConfig, tree: dict, *, device="cpu") -> dict:
    runs = stack.compute_runs(cfg)
    if len(tree["runs"]) != len(runs):
        raise ValueError(f"tree has {len(tree['runs'])} runs, {cfg.name} at "
                         f"{cfg.num_layers} layers has {len(runs)}")
    layers = []
    for run, plist in zip(runs, tree["runs"]):
        for rep in range(run.count):
            for sub in plist:
                if run.count == 1:
                    layers.append(_map(sub, lambda a: to_tensor(a, device)))
                else:
                    layers.append(_map(sub, lambda a, r=rep: to_tensor(a[r], device)))
    return {"head": _map(tree["head"], lambda a: to_tensor(a, device)), "layers": layers}
