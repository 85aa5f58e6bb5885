"""Uniform model API: dispatch by cfg.family (counterpart of ``repro.models.registry``).

Every family module implements:
  init_params(cfg, device=, seed=)
  forward(cfg, params, batch) -> (logits, aux)
  init_cache(cfg, batch, seq_len, device=)
  prefill(cfg, params, cache, batch) -> (logits, cache)
  decode_step(cfg, params, cache, tokens, pos) -> (logits, cache)
``dense`` and ``vlm`` (``models.transformer``) and ``moe`` (with MHA or MLA
attention) are ported; the other families raise and name the ROADMAP slice
that brings them.  ``loss_fn`` and training come with the training slice.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig

_LATER = {
    "ssm": "slice 4 (the ssm family with the rwkv6_scan kernel K4)",
    "hybrid": "ROADMAP Queue 1 item 9 (hymba), after slice 4",
    "encdec": "ROADMAP Queue 1 item 9 (whisper), after slice 4",
}


def family_module(cfg: ModelConfig):
    if cfg.family in ("dense", "vlm"):
        from repro_torch.models import transformer
        return transformer
    if cfg.family == "moe":
        from repro_torch.models import moe
        return moe
    if cfg.family in _LATER:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported "
                                  f"yet: see ROADMAP.md, {_LATER[cfg.family]}")
    raise KeyError(f"unknown family {cfg.family!r}")


def init_params(cfg: ModelConfig, *, device, seed: int = 0):
    return family_module(cfg).init_params(cfg, device=device, seed=seed)


def forward(cfg: ModelConfig, params, batch):
    return family_module(cfg).forward(cfg, params, batch)


def prefill(cfg: ModelConfig, params, cache, batch):
    """Batched prefill from position 0: (logits, cache filled in place)."""
    return family_module(cfg).prefill(cfg, params, cache, batch)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device):
    return family_module(cfg).init_cache(cfg, batch, seq_len, device=device)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    return family_module(cfg).decode_step(cfg, params, cache, tokens, pos)


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict/list tree, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for item in items for t in leaves(item)]


@functools.lru_cache(maxsize=64)
def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``, counted on the meta device (nothing allocated)."""
    return sum(t.numel() for t in leaves(init_params(cfg, device="meta")))
