"""Plain torch version of single-token GQA decode attention.

Counterpart of ``repro.kernels.decode_attention.ref``, taken in the model's
own layout: q (B, 1, H, D) one query token per sequence, k, v the full cache
(B, T, K, D) with H = K * G, pos (B,) current absolute positions (keys at
indices > pos are masked).  Returns (B, 1, H, D) in q.dtype.  It is the CPU
path of the wrapper and the version the CUDA kernel is held to on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def decode_attention_ref(q, k, v, pos, *, softcap: Optional[float] = None):
    b, _, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    qg = q[:, 0].reshape(b, kh, h // kh, d).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) / math.sqrt(d)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    mask = torch.arange(t, device=q.device)[None, :] <= pos[:, None]   # (B, T)
    scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
