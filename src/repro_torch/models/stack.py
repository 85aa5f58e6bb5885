"""Layer signatures and the JAX package's run compression.

Counterpart of ``repro.models.stack``.  The port holds its layers as a flat
per-layer list (PyTorch runs eagerly; there is no scan to compress for), but
keeps ``compute_runs`` so that ``repro_torch.models.convert`` can unstack the
JAX package's run-stacked parameter trees.  ``maybe_remat`` is
``_maybe_remat``: activation checkpointing of one layer as ``cfg.remat``
says, applied by each family's ``_hidden`` to every layer of its list (the
JAX package applies it to each run's scan body, a layer or a repeated unit
of layers; the values are the same).

A run is ``count`` repetitions of a ``unit`` of one or more sub-layers:
gemma3's "LLLLLG" pattern over 34 layers is ``[Run(5, (L,L,L,L,L,G)),
Run(4, (L,))]``, over 6 layers ``[Run(5, (L,)), Run(1, (G,))]``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, registry

LayerSig = tuple[Optional[int], str]     # (window, kind)


@dataclasses.dataclass(frozen=True)
class Run:
    count: int                  # number of unit repetitions
    unit: tuple[LayerSig, ...]  # sub-layers applied per repetition


def layer_windows(cfg: ModelConfig) -> list[Optional[int]]:
    if cfg.family in ("ssm",):
        return [None] * cfg.num_layers
    if cfg.family == "hybrid":
        return [None if i in cfg.full_attn_layers else cfg.sliding_window
                for i in range(cfg.num_layers)]
    pat = cfg.attn_pattern or "G"
    out = []
    for i in range(cfg.num_layers):
        c = pat[i % len(pat)]
        out.append(None if c == "G" else cfg.sliding_window)
    return out


def layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.num_experts > 0:
        return ["dense" if i < cfg.first_dense_layers else "moe"
                for i in range(cfg.num_layers)]
    return ["dense"] * cfg.num_layers


def layer_sigs(cfg: ModelConfig) -> list[LayerSig]:
    return list(zip(layer_windows(cfg), layer_kinds(cfg)))


def _compress_homogeneous(sigs: list[LayerSig]) -> list[Run]:
    runs: list[Run] = []
    for s in sigs:
        if runs and runs[-1].unit == (s,):
            runs[-1] = Run(runs[-1].count + 1, (s,))
        else:
            runs.append(Run(1, (s,)))
    return runs


def compute_runs(cfg: ModelConfig) -> list[Run]:
    sigs = layer_sigs(cfg)
    n = len(sigs)
    if not cfg.scan_layers:
        return [Run(1, (s,)) for s in sigs]
    # periodic block compression (layer i sig depends only on i % p)
    pat = cfg.attn_pattern or "G"
    p = len(pat)
    if p > 1 and cfg.family not in ("hybrid", "ssm"):
        full = n // p
        if full >= 2 and all(sigs[i] == sigs[i % p] for i in range(full * p)):
            runs = [Run(full, tuple(sigs[:p]))]
            runs += _compress_homogeneous(sigs[full * p:])
            return runs
    return _compress_homogeneous(sigs)


def run_specs(cfg: ModelConfig, layer_specs: Callable) -> list:
    """The spec tree of the port's flat layer list: one ``layer_specs(cfg,
    kind)`` a layer.  It is the JAX package's run-stacked tree
    (``repro.models.stack.run_specs``) carried through ``convert``'s
    layout change: a repeated run's leading "layers" axis is dropped
    (``LOGICAL_RULES["layers"]`` is ``None``, so nothing is lost)."""
    return [layer_specs(cfg, kind) for kind in layer_kinds(cfg)]


def cache_run_specs(cfg: ModelConfig, layer_cache_specs: Callable) -> list:
    """The spec tree of the port's per-layer cache list (see ``run_specs``)."""
    return [layer_cache_specs(cfg, kind) for kind in layer_kinds(cfg)]


# the products whose outputs remat="dots" keeps (the JAX package's
# dots_with_no_batch_dims_saveable); everything else is recomputed
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def maybe_remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn(cfg, p, x, ...)`` under activation checkpointing: ``none`` keeps
    every activation, ``full`` keeps the layer's inputs and recomputes the
    rest in the backward, ``dots`` also keeps the outputs of its products.
    Applied only when autograd records through ``p`` or ``x``."""
    if cfg.remat == "none":
        return fn
    context = {}
    if cfg.remat == "dots":
        context["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                  list(DOT_OPS))

    @functools.wraps(fn)
    def run(cfg, p, x, *args, **kw):
        if not layers.grad_needed(x, *registry.leaves(p)):
            return fn(cfg, p, x, *args, **kw)
        return checkpoint(fn, cfg, p, x, *args, use_reentrant=False, **context, **kw)
    return run
