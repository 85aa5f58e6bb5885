"""Deterministic, restart-safe synthetic data pipeline.

Batches are a pure function of (seed, step): a restart at step k reproduces
the exact token stream without replaying the first k-1 steps.  Documents with
lognormal lengths are greedily packed into fixed-length rows (pad-free LM
training); the loss mask zeroes cross-document boundaries.

``DataConfig`` and ``batch_at`` are a copy of ``repro.training.data``'s
(numpy, the same bits); ``torch_batch_at`` takes ``jax_batch_at``'s place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: float = 512.0


def batch_at(cfg: DataConfig, step: int) -> dict:
    """Deterministic batch for *step* (numpy)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    b, s = cfg.global_batch, cfg.seq_len
    tokens = rng.integers(1, cfg.vocab_size, size=(b, s + 1), dtype=np.int32)
    # pack documents: sample boundaries, zero loss across them
    mask = np.ones((b, s), np.float32)
    sigma = 0.6
    mu = np.log(cfg.mean_doc_len) - sigma ** 2 / 2
    for i in range(b):
        t = 0
        while t < s:
            doc = max(16, int(rng.lognormal(mu, sigma)))
            end = min(t + doc, s)
            if end < s:
                tokens[i, end] = 0          # document separator
                mask[i, end] = 0.0
            t = end + 1
    return {"tokens": tokens[:, :-1],
            "targets": tokens[:, 1:],
            "loss_mask": mask}


def torch_batch_at(cfg: DataConfig, step: int, device: DeviceLike = None,
                   extras: dict | None = None) -> dict:
    """``batch_at`` as tensors on ``device`` (CUDA unless the CPU is named),
    with ``extras`` (e.g. a vlm's ``patch_embeds``) added."""
    device = resolve_device(device)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch_at(cfg, step).items()}
    if extras:
        out.update(extras)
    return out
