"""Embedding / LM-head helpers and the LM losses (counterpart of
``repro.models.head``)."""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import gather_rows, shard
from repro_torch.models import layers


def init(cfg: ModelConfig, gen, device) -> dict:
    p = {"embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.pdtype, device),
         "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size, cfg.pdtype, device)
    return p


def specs(cfg: ModelConfig) -> dict:
    s = {"embed": ("vocab", "embed"), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        s["lm_head"] = ("embed", "vocab")
    return s


def embed(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    x = gather_rows(p["embed"], tokens).to(cfg.cdtype)
    # the JAX package multiplies by a weakly typed scalar, i.e. sqrt(d_model)
    # rounded to the compute dtype first; round it the same way, on the host
    # (a scalar tensor sent to the device would cost a stream sync)
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype).item()
    return shard(x * scale, "batch", None, "embed")


def logits(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    out = layers.softcap(x @ _head_weight(cfg, p), cfg.final_logit_softcap)
    return shard(out, "batch", None, "vocab")


def _head_weight(cfg: ModelConfig, p) -> torch.Tensor:
    """The (d, V) LM head in the compute dtype.  On a DTensor it is gathered
    whole along d first (the FSDP gather of a training cell): left sharded
    there, DTensor contracts over the data axis and reduce-scatters every
    chunk of logits instead."""
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return shard(w.to(cfg.cdtype), None, "vocab")


def loss_from_logits(lgts: torch.Tensor, batch: dict) -> torch.Tensor:
    return layers.cross_entropy(lgts, batch["targets"], batch.get("loss_mask"))


def chunked_loss(cfg: ModelConfig, p, x: torch.Tensor, batch: dict,
                 chunk: int = 512) -> torch.Tensor:
    """Cross entropy without ever materialising the full-sequence logits.

    The LM head runs over sequence chunks of the largest divisor of S that is
    <= ``chunk``; when autograd records, each of several chunks runs under
    ``checkpoint``, so the backward recomputes one chunk's logits at a time
    (at gemma3-4b's 262,144-token vocabulary a 512-token chunk's float32
    logits are 0.54 GB a sequence).  Sums run in the JAX package's order: per chunk, then chunk
    by chunk from zero."""
    s = x.shape[1]
    targets, mask = batch["targets"], batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=x.device)
    x = layers.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    w = _head_weight(cfg, p)

    cb = min(chunk, s)
    while s % cb:
        cb -= 1

    def body(xc, w, tc, mc):
        lg = layers.softcap(xc @ w, cfg.final_logit_softcap)
        lg = shard(lg, "batch", None, "vocab")
        return (layers.nll(lg, tc) * mc).sum(), mc.sum()

    # one chunk is not checkpointed: its recomputation would free nothing
    # that the backward does not make again at once (XLA merges the JAX
    # package's single checkpointed call with its forward the same way)
    remat = layers.grad_needed(x, w) and cb < s
    nll_sum = msum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, cb):
        args = (x[:, i:i + cb], w, targets[:, i:i + cb], mask[:, i:i + cb])
        nll, m = checkpoint(body, *args, use_reentrant=False) if remat else body(*args)
        nll_sum, msum = nll_sum + nll, msum + m
    return nll_sum / torch.clamp(msum, min=1.0)
