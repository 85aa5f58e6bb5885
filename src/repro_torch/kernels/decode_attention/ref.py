"""Plain torch versions of single-token GQA decode attention.

Counterpart of ``repro.kernels.decode_attention.ref``, taken in the model's
own layout: q (B, 1, H, D) one query token per sequence, k, v the full cache
(B, T, K, D) with H = K * G, pos (B,) current absolute positions (keys at
indices > pos are masked).  Returns (B, 1, H, D) in q.dtype.  It is the CPU
path of the wrapper and the version the CUDA kernel is held to on the card.
``decode_attention_split_ref`` is the CUDA kernel's decomposition over the
live keys (``split_ranges``), for the tests; ``decode_attention_f64_ref`` the
same attention in float64, which the bf16 kernel is held to tightly.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _attend(q, k, v, pos, softcap, dtype):
    """The attention of q over the keys <= pos, computed in ``dtype`` and returned in it."""
    b, _, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    qg = q[:, 0].reshape(b, kh, h // kh, d).to(dtype)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k.to(dtype)) / math.sqrt(d)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    mask = torch.arange(t, device=q.device)[None, :] <= pos[:, None]   # (B, T)
    scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v.to(dtype))
    return out.reshape(b, 1, h, d)


def decode_attention_ref(q, k, v, pos, *, softcap: Optional[float] = None):
    return _attend(q, k, v, pos, softcap, torch.float32).to(q.dtype)


def decode_attention_f64_ref(q, k, v, pos, *, softcap: Optional[float] = None):
    """The same attention of the same (e.g. bf16) inputs in float64, not rounded to q.dtype:
    the value a bf16 call rounds once.  The card's tight hold of the bf16 kernel; no model
    path calls it."""
    return _attend(q, k, v, pos, softcap, torch.float64)


def split_ranges(pos, t: int, n_split: int, tile: int = 16) -> list[list[tuple[int, int]]]:
    """Each row's keys [begin, end) per split, as the CUDA kernel divides them: the row's
    pos + 1 live keys (at most t) in runs of ``tile`` keys, the same number of runs to each
    split but the last; splits past the live keys get (begin, begin) and read nothing."""
    rows = []
    for p in pos.tolist():
        live = max(0, min(int(p) + 1, t))
        units = -(-live // tile)
        ups = -(-units // n_split)
        rows.append([(min(s * ups * tile, live), min((s + 1) * ups * tile, live))
                     for s in range(n_split)])
    return rows


def decode_attention_split_ref(q, k, v, pos, n_split: int, tile: int = 16, *,
                               softcap: Optional[float] = None):
    """The kernel's decomposition in plain torch: each split's (m, l, acc) of an online
    softmax over its keys (``split_ranges``), then the merge of the live splits, divided by
    max(l, 1e-30).  Same layout and result as ``decode_attention_ref``; for the tests."""
    b, _, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q[:, 0].reshape(b, kh, g, d).float() / math.sqrt(d)
    out = torch.zeros((b, kh, g, d), dtype=torch.float32, device=q.device)
    for bi, ranges in enumerate(split_ranges(pos, t, n_split, tile)):
        parts = []
        for begin, end in ranges:
            if begin == end:
                continue
            s = torch.einsum("kgd,tkd->kgt", qg[bi], k[bi, begin:end].float())
            if softcap is not None:
                s = torch.tanh(s / softcap) * softcap
            m = s.amax(-1)                                            # (K, G)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgt,tkd->kgd", p, v[bi, begin:end].float())))
        if not parts:
            continue
        mt = torch.stack([m for m, _, _ in parts]).amax(0)
        lt = sum(torch.exp(m - mt) * l for m, l, _ in parts)
        acc = sum(torch.exp(m - mt)[..., None] * a for m, _, a in parts)
        out[bi] = acc / lt.clamp_min(1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)
