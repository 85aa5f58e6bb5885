"""Plain torch version of flash attention (causal, sliding window, softcap, GQA).

Counterpart of ``repro.kernels.flash_attention.ref``, taken in the model's
own layout: q (B, S, H, D), k, v (B, T, K, D) with H = K * G (query head h
reads kv head h // G).  Query row i sits at absolute position i + q_offset;
key j is visible to it when j <= i + q_offset (causal) and
j > i + q_offset - window.  Returns (B, S, H, D) in q.dtype, computed in
float32.  It is the CPU path of the wrapper and the version the CUDA kernel
is held to on the card.

One difference from the JAX ``flash_attention_ref``: a query row that sees
no key at all (only where S > T or with an odd window/offset, never on the
model's paths) is 0 here, as the Pallas and CUDA kernels write it
(``acc / max(l, 1e-30)``); the JAX reference gives the mean of v there.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def visible(s: int, t: int, *, causal: bool, window: Optional[int], q_offset: int,
            device=None) -> torch.Tensor:
    """(S, T) bool: which keys each query row sees."""
    qpos = q_offset + torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, q_offset: int = 0):
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(d)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    mask = visible(s, t, causal=causal, window=window, q_offset=q_offset, device=q.device)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True)).masked_fill_(~mask, 0.0)
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
