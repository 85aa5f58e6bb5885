"""Embedding / LM-head helpers (counterpart of ``repro.models.head``)."""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def init(cfg: ModelConfig, gen, device) -> dict:
    p = {"embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.pdtype, device),
         "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size, cfg.pdtype, device)
    return p


def embed(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    x = p["embed"][tokens].to(cfg.cdtype)
    # the JAX package multiplies by a weakly typed scalar, i.e. sqrt(d_model)
    # rounded to the compute dtype first; round it the same way, on the host
    # (a scalar tensor sent to the device would cost a stream sync)
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype).item()
    return x * scale


def logits(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return layers.softcap(x @ w.to(cfg.cdtype), cfg.final_logit_softcap)
