"""Carry the JAX package's parameters across into the port's layout.

``params_from_jax(cfg, tree)`` takes the JAX parameter pytree after
``jax.tree.map(np.asarray, params)`` (nested dicts/lists of numpy arrays) and
returns the port's ``{"head": ..., "layers": [...]}`` (plus hymba's
top-level ``"meta"``).  The JAX tree stacks its layers by run
(``stack.compute_runs``): ``tree["runs"][i][j]`` holds sub-layer j of run i,
with a leading axis of ``run.count`` when the run repeats.  Layer order is
run by run, repetition by repetition, sub-layer by sub-layer.  Whisper's tree
(``encdec``) has no runs: ``enc`` and ``dec`` each stack every layer on a
leading axis, and become the port's ``"enc"`` and ``"dec"`` lists.
``opt_state_from_jax`` carries an AdamW state across the same way (a
gradient tree goes through ``params_from_jax``).  This module needs no jax:
it reads numpy arrays only.
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


def _unstack(tree, n: int, device) -> list:
    """A tree whose leaves stack n layers on axis 0 -> n per-layer trees."""
    return [_map(tree, lambda a, i=i: to_tensor(a[i], device)) for i in range(n)]


def params_from_jax(cfg: ModelConfig, tree: dict, *, device="cpu") -> dict:
    head = _map(tree["head"], lambda a: to_tensor(a, device))
    if cfg.family == "encdec":
        return {"head": head, "enc": _unstack(tree["enc"], cfg.num_encoder_layers, device),
                "dec": _unstack(tree["dec"], cfg.num_layers, device),
                "enc_norm": to_tensor(tree["enc_norm"], device)}
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
    out = {"head": head, "layers": layers}
    if "meta" in tree:
        out["meta"] = to_tensor(tree["meta"], device)
    return out


def opt_state_from_jax(cfg: ModelConfig, state: dict, *, device="cpu") -> dict:
    """The JAX package's AdamW state ``{"m", "v", "step"}`` (numpy leaves) ->
    the port's: the moments through the same mapping as the parameters."""
    return {"m": params_from_jax(cfg, state["m"], device=device),
            "v": params_from_jax(cfg, state["v"], device=device),
            "step": to_tensor(state["step"], device)}
