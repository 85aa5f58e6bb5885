"""Shared model building blocks (plain torch, dicts of tensors).

Counterpart of ``repro.models.layers``: init helpers, norms, RoPE, the
memory-bounded reference ``attention()`` of the prefill/forward path and the
decode pieces, sinusoidal positions (whisper), the SwiGLU MLP and the
cross-entropy loss.
Parameter layouts are the JAX package's (e.g. ``wq`` is ``(d_model, H, D)``),
so weights carry across unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def grad_needed(*tensors) -> bool:
    """True when autograd records and a tensor among ``tensors`` requires grad:
    the training path.  Serving, prefill and forward hold parameters that
    require none, and keep their memory-lean in-place forms."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)

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


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


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


def sinusoidal_pos(seq: int, dim: int, device=None) -> torch.Tensor:
    """(seq, dim) float32 absolute positions: sin on even columns, cos on odd."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# attention (plain path; the CUDA kernels in repro_torch.kernels implement the
# same contract)
# ---------------------------------------------------------------------------


def _gqa_scores(q, k, softcap_val, score_dtype=torch.float32):
    # q: (B, qb, H, D) ; k: (B, T, K, D) ; H = K*G.  Products in float32, as
    # the JAX einsum's preferred_element_type, held in score_dtype.
    b, s, h, d = q.shape
    kheads = k.shape[2]
    g = h // kheads
    q = q.reshape(b, s, kheads, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()).to(score_dtype)
    scores = scores / math.sqrt(d)
    return softcap(scores, softcap_val)  # (B, K, G, qb, T)


def _gqa_out(probs, v):
    # probs: (B, K, G, qb, T), v: (B, T, K, D) -> (B, qb, H, D) float32
    out = torch.einsum("bkgst,btkd->bskgd", probs.float(), v.float())
    b, s, kh, g, d = out.shape
    return out.reshape(b, s, kh * g, d)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              logit_softcap: Optional[float] = None, q_block: int = 512,
              q_offset: int = 0, score_dtype=torch.float32) -> torch.Tensor:
    """Memory-bounded multi-head attention with GQA.

    q: (B, S, H, D); k, v: (B, T, K, D).  Returns (B, S, H, Dv) in q.dtype;
    Dv (v's last dim) may differ from D (MLA: qk 192, v 128).  ``q_offset``
    is the absolute position of q[0].  Loops over query blocks of the largest
    divisor of S that is <= q_block; windowed layers slice the key range to
    ``min(T, qb + window)`` keys, so compute is O(S * window), not O(S * T).
    A query row with no visible key gets the mean of v, as in the JAX package.
    When autograd records, each query block runs under ``checkpoint`` (the
    JAX package's ``@jax.checkpoint``), so a backward recomputes one block's
    scores at a time and never holds every block's.
    """
    b, s, h, d = q.shape
    t = k.shape[1]
    dv = v.shape[-1]
    out_dtype = q.dtype

    if s == 1:
        # decode fast path: single query token, full-row softmax
        scores = _gqa_scores(q, k, logit_softcap, score_dtype)        # (B,K,G,1,T)
        key_idx = torch.arange(t, device=q.device)
        mask = (key_idx <= q_offset) if causal else torch.ones(t, dtype=torch.bool,
                                                               device=q.device)
        if window is not None:
            mask = mask & (key_idx > q_offset - window)
        scores = scores.masked_fill(~mask, NEG_INF)
        return _gqa_out(torch.softmax(scores, dim=-1), v).to(out_dtype)

    qb = min(q_block, s)
    while s % qb:        # largest divisor of s <= q_block
        qb -= 1
    key_span = t if window is None else min(t, qb + int(window))

    def block(q, k, v, qi: int):
        qpos = q_offset + qi + torch.arange(qb, device=q.device)
        kstart = 0 if window is None else min(max(qi + q_offset - window + 1, 0), t - key_span)
        kpos = kstart + torch.arange(key_span, device=q.device)
        scores = _gqa_scores(q[:, qi:qi + qb], k[:, kstart:kstart + key_span],
                             logit_softcap, score_dtype)               # (B,K,G,qb,span)
        mask = torch.ones((qb, key_span), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
        return _gqa_out(probs, v[:, kstart:kstart + key_span]).to(out_dtype)

    if grad_needed(q, k, v):
        return torch.cat([checkpoint(block, q, k, v, qi, use_reentrant=False)
                          for qi in range(0, s, qb)], dim=1)
    out = torch.empty((b, s, h, dv), dtype=out_dtype, device=q.device)
    for qi in range(0, s, qb):
        out[:, qi:qi + qb] = block(q, k, v, qi)
    return out


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


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood: the float32 logsumexp of (..., V)
    logits minus the gold logit.  The gold logit is gathered; the JAX
    package's one-hot reduction (kept there for a vocab-sharded axis) sums
    the same value with zeros, so both give the same number."""
    logits = logits.float()
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, V) logits against (B, S) ids, averaged over the mask
    (``sum / max(mask.sum(), 1)``) or over every position."""
    nll_ = nll(logits, targets)
    if mask is not None:
        return (nll_ * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll_.mean()
