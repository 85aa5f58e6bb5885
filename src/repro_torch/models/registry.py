"""Uniform model API: dispatch by cfg.family (counterpart of ``repro.models.registry``).

Every family module implements:
  init_params(cfg, device=, seed=)
  forward(cfg, params, batch) -> (logits, aux)
  init_cache(cfg, batch, seq_len, device=)
  prefill(cfg, params, cache, batch) -> (logits, cache)
  decode_step(cfg, params, cache, tokens, pos) -> (logits, cache)
  loss_fn(cfg, params, batch) -> (loss, aux)
Every family of the JAX package's registry is ported: ``dense`` and ``vlm``
(``models.transformer``), ``moe`` (with MHA or MLA attention), ``ssm``
(``models.rwkv6``), ``hybrid`` (``models.hymba``) and ``encdec``
(``models.whisper``).  ``reset_slot`` zeroes one serving slot's recurrent
state, for the families that keep one (ssm, hybrid).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig

def family_module(cfg: ModelConfig):
    if cfg.family in ("dense", "vlm"):
        from repro_torch.models import transformer
        return transformer
    if cfg.family == "moe":
        from repro_torch.models import moe
        return moe
    if cfg.family == "ssm":
        from repro_torch.models import rwkv6
        return rwkv6
    if cfg.family == "hybrid":
        from repro_torch.models import hymba
        return hymba
    if cfg.family == "encdec":
        from repro_torch.models import whisper
        return whisper
    raise KeyError(f"unknown family {cfg.family!r}")


def init_params(cfg: ModelConfig, *, device, seed: int = 0):
    return family_module(cfg).init_params(cfg, device=device, seed=seed)


def forward(cfg: ModelConfig, params, batch):
    return family_module(cfg).forward(cfg, params, batch)


def loss_fn(cfg: ModelConfig, params, batch):
    """The training loss (chunked cross entropy, + the moe aux) -> (loss, aux)."""
    return family_module(cfg).loss_fn(cfg, params, batch)


def prefill(cfg: ModelConfig, params, cache, batch):
    """Batched prefill from position 0: (logits, cache filled in place)."""
    return family_module(cfg).prefill(cfg, params, cache, batch)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device):
    return family_module(cfg).init_cache(cfg, batch, seq_len, device=device)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    return family_module(cfg).decode_step(cfg, params, cache, tokens, pos)


def reset_slot(cfg: ModelConfig, cache, slot: int) -> None:
    """Zero batch row ``slot`` of a recurrent cache in place, so that a request
    placed in a reused serving slot starts from a fresh state.  Attention
    caches are left as they are: positions at or past a slot's ``pos`` are
    masked (a hymba ring layer's slots of the meta positions aside, which a
    served request attends and never writes, as in the JAX package)."""
    reset = getattr(family_module(cfg), "reset_slot", None)
    if reset is not None:
        reset(cache, slot)


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
