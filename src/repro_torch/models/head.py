"""Embedding / LM-head helpers and the LM losses (counterpart of
``repro.models.head``)."""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

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


def loss_from_logits(lgts: torch.Tensor, batch: dict) -> torch.Tensor:
    return layers.cross_entropy(lgts, batch["targets"], batch.get("loss_mask"))


def chunked_loss(cfg: ModelConfig, p, x: torch.Tensor, batch: dict,
                 chunk: int = 512) -> torch.Tensor:
    """Cross entropy without ever materialising the full-sequence logits.

    The LM head runs over sequence chunks of the largest divisor of S that is
    <= ``chunk``; when autograd records, each chunk runs under ``checkpoint``,
    so the backward recomputes one chunk's logits at a time (at gemma3-4b's
    262,144-token vocabulary a 512-token chunk's float32 logits are 0.54 GB a
    sequence).  Sums run in the JAX package's order: per chunk, then chunk
    by chunk from zero."""
    s = x.shape[1]
    targets, mask = batch["targets"], batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=x.device)
    x = layers.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]

    cb = min(chunk, s)
    while s % cb:
        cb -= 1

    def body(xc, w, tc, mc):
        lg = layers.softcap(xc @ w.to(cfg.cdtype), cfg.final_logit_softcap)
        return (layers.nll(lg, tc) * mc).sum(), mc.sum()

    remat = layers.grad_needed(x, w)
    nll_sum = msum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, cb):
        args = (x[:, i:i + cb], w, targets[:, i:i + cb], mask[:, i:i + cb])
        nll, m = checkpoint(body, *args, use_reentrant=False) if remat else body(*args)
        nll_sum, msum = nll_sum + nll, msum + m
    return nll_sum / torch.clamp(msum, min=1.0)
