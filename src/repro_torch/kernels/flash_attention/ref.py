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

``flash_attention_bf16p_ref`` is the bf16 CUDA kernels' own arithmetic, which
they are also held to, more tightly.
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


def flash_attention_bf16p_ref(q, k, v, *, block_k: int, causal: bool = True,
                              window: Optional[int] = None, softcap: Optional[float] = None,
                              q_offset: int = 0, round_p: bool = True):
    """As the bf16 CUDA kernels compute it: an online softmax over key tiles
    [j * block_k, (j + 1) * block_k) in order, P = exp(s - m) at the tile's
    running max m rounded to q.dtype before P V (round_p), the row sum l taken
    from the unrounded P, sums in float64 (the kernels' fp32 sums differ from
    them by reordering only), out rounded once to q.dtype.  A row with no
    visible key is 0.  With round_p off it is the exact attention, in float64."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, d).double()
    kd, vd = k.double(), v.double()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, kd) / math.sqrt(d)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    mask = visible(s, t, causal=causal, window=window, q_offset=q_offset, device=q.device)
    scores = scores.masked_fill(~mask, -math.inf)
    m = torch.full(scores.shape[:-1] + (1,), -math.inf, dtype=torch.float64, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(scores.shape[:-1] + (d,), dtype=torch.float64, device=q.device)
    for k0 in range(0, t, block_k):
        sc = scores[..., k0:k0 + block_k]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        # a row that has seen no key yet takes its exponents from 0: p = 0, alpha = 0
        base = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(sc - base)
        l = alpha * l + p.sum(-1, keepdim=True)
        if round_p:
            p = p.to(q.dtype).double()
        acc = alpha * acc + torch.einsum("bkgst,btkd->bkgsd", p, vd[:, k0:k0 + block_k])
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
