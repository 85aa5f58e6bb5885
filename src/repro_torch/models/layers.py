"""Shared model building blocks for decode (plain torch, dicts of tensors).

Counterpart of ``repro.models.layers``, restricted to what one-token decode
needs; the prefill/training ``attention()`` and the losses come with later
slices.  Parameter layouts are the JAX package's (e.g. ``wq`` is
``(d_model, H, D)``), so weights carry across unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    # float32 draws, cast afterwards, as the JAX package does; the meta device
    # (shape-only counting) takes no generator
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def dense_init(gen, in_dim: int, out_shape, dtype, device) -> torch.Tensor:
    """Fan-in scaled normal init; out_shape may be a tuple (fused heads)."""
    if isinstance(out_shape, int):
        out_shape = (out_shape,)
    scale = 1.0 / math.sqrt(in_dim)
    # scaled in place: an expert tensor's float32 draw is ~0.7 GB at full width
    return _normal(gen, (in_dim, *out_shape), device).mul_(scale).to(dtype)


def embed_init(gen, vocab: int, dim: int, dtype, device) -> torch.Tensor:
    return (_normal(gen, (vocab, dim), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# rotary embeddings (half-split, not interleaved, in float32)
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    angles = positions[..., None].float() * freqs          # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention pieces (plain path; the decode kernel lives in repro_torch.kernels)
# ---------------------------------------------------------------------------


def _gqa_scores(q, k, softcap_val):
    # q: (B, qb, H, D) ; k: (B, T, K, D) ; H = K*G.  Scores in float32, as the
    # JAX einsum's preferred_element_type.
    b, s, h, d = q.shape
    kheads = k.shape[2]
    g = h // kheads
    q = q.reshape(b, s, kheads, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())
    scores = scores / math.sqrt(d)
    return softcap(scores, softcap_val)  # (B, K, G, qb, T)


def _gqa_out(probs, v):
    # probs: (B, K, G, qb, T), v: (B, T, K, D) -> (B, qb, H, D) float32
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    b, s, kh, g, d = out.shape
    return out.reshape(b, s, kh * g, d)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu_init(gen, d_model: int, d_ff: int, dtype, device) -> dict:
    return {
        "wi_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "wi_up": dense_init(gen, d_model, d_ff, dtype, device),
        "wo": dense_init(gen, d_ff, d_model, dtype, device),
    }


def swiglu_apply(p, x, cdtype):
    gate = x @ p["wi_gate"].to(cdtype)
    up = x @ p["wi_up"].to(cdtype)
    return (F.silu(gate) * up) @ p["wo"].to(cdtype)
