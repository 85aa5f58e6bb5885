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

from repro_torch.distributed.sharding import (contiguous_stride, div_axis, is_dtensor,
                                              local_map, local_under, shard)

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


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (x: (..., in), w: (in, out)) as one 2-D product over x's
    leading dims folded together.  DTensor gives a batch sharded next to a
    size-1 dim (a decode step's S) a global stride that ``matmul`` will not
    fold, and ``matmul`` would then copy the weight to every batch row."""
    return (x.reshape(-1, x.shape[-1]) @ w).unflatten(0, x.shape[:-1])


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


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``torch.softmax`` over the last dim; on a DTensor, the max, the
    exponentials and their sum, which keep a sharded last dim (a split-K
    cache's keys) where it is: DTensor gathers the whole dim for a softmax."""
    if not is_dtensor(x):
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.detach().amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _per_query_head(q, kv):
    """``kv`` (B, T, K, D) with each kv head repeated over its G query heads,
    where query heads are sharded over "model" and the K kv heads cannot be
    (a DTensor cannot split a shard of H into (K, G)); else ``kv`` as it is."""
    h, kheads = q.shape[2], kv.shape[2]
    if (h == kheads or not is_dtensor(q) or div_axis("kv_heads", kheads) is not None
            or not any(getattr(p, "dim", None) == 2 for p in q.placements)):
        return kv
    b, t, _, d = kv.shape
    return kv[:, :, :, None].expand(b, t, kheads, h // kheads, d).reshape(b, t, h, d)


def by_heads(fn, q, k, v, *rest, rest_specs=()):
    """``fn(q, k, v, *rest)`` (q: (B, S, H, D); k, v: (B, T, K, D); -> (B, S,
    H, Dv)), on DTensors run on the rank's own batch rows and heads: attention
    is independent per batch row and kv head, and DTensor cannot fold a
    sharded head axis into the batch of its products.  Where a mesh axis
    shards the keys' T (a split-K decode cache), the softmax spans the ranks
    and ``fn`` runs on the DTensors as they are."""
    if not is_dtensor(q) or any(getattr(p, "dim", None) == 1
                                for p in getattr(k, "placements", ())):
        return fn(q, k, v, *rest)
    k, v = _per_query_head(q, k), _per_query_head(q, v)
    h = q.shape[2]
    qh = div_axis("heads", h)
    kh = qh if k.shape[2] == h else div_axis("kv_heads", k.shape[2])
    if (qh is None) != (kh is None):      # every rank takes every head
        qh = kh = None
    qs, ks = ("batch", None, qh, None), ("batch", None, kh, None)
    out = (q.shape[0], q.shape[1], h, v.shape[-1])
    return local_map(lambda *a: (fn(*a),), [qs, ks, ks, *rest_specs], [(qs, out)],
                     q, k, v, *rest)[0]


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
    if is_dtensor(out):
        # held to the heads' own axis before they merge: DTensor may have
        # split the product over a mesh axis that no input uses, unevenly
        ax = div_axis("kv_heads", kh) or (div_axis("heads", kh) if g == 1 else None)
        out = shard(out, "batch", None, ax, None, None)
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
    if is_dtensor(q):
        return by_heads(lambda q, k, v: attention(
            q, k, v, causal=causal, window=window, logit_softcap=logit_softcap,
            q_block=q_block, q_offset=q_offset, score_dtype=score_dtype), q, k, v)
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
        return _gqa_out(softmax(scores), v).to(out_dtype)

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


def swiglu_specs():
    return {
        "wi_gate": ("embed", "ffn"),
        "wi_up": ("embed", "ffn"),
        "wo": ("ffn", "embed"),
    }


def swiglu_apply(p, x, cdtype):
    gate = x @ p["wi_gate"].to(cdtype)
    up = x @ p["wi_up"].to(cdtype)
    h = shard(F.silu(gate) * up, "batch", None, "ffn")
    return h @ p["wo"].to(cdtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood: the float32 logsumexp of (..., V)
    logits minus the gold logit.  The gold logit is gathered; on DTensor
    logits it is the JAX package's one-hot sum (the same value summed with
    zeros), reduced on each rank's vocabulary shard (``_sharded_nll``)."""
    logits = logits.float()
    if is_dtensor(logits):
        return _sharded_nll(logits, targets)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def _sharded_nll(logits, targets):
    """``nll`` of DTensor logits: each rank reduces its own rows and its
    vocabulary shard, and the max, the summed exponentials and the gold
    logit meet across the vocabulary's mesh axes as one scalar a position
    (an all-reduce each).  DTensor's own ops would move whole logits between
    shardings in the backward."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    dm, pl, last = logits.device_mesh, logits.placements, logits.dim() - 1
    vocab = [p.is_shard() and p.dim == last for p in pl]
    rows = [Replicate() if v else p for v, p in zip(vocab, pl)]
    shape = torch.Size(logits.shape[:-1])

    def whole(x, reduce=None):          # (..., ) per-position results over the mesh
        src = [Partial(reduce) if v else p for v, p in zip(vocab, rows)] if reduce else rows
        d = DTensor.from_local(x, dm, src, run_check=False, shape=shape,
                               stride=contiguous_stride(shape))
        return d.redistribute(dm, rows) if reduce else d

    loc = logits.to_local()
    _, off = compute_local_shape_and_global_offset(logits.shape, dm, pl)
    ids = local_under(targets, dm, rows).long() - off[last]
    hit = ids[..., None] == torch.arange(loc.shape[-1], device=loc.device)
    top = whole(loc.detach().amax(-1), "max").to_local()
    summed = whole(torch.exp(loc - top[..., None]).sum(-1), "sum")
    gold = whole(torch.where(hit, loc, 0.0).sum(-1), "sum")
    return torch.log(summed) + whole(top) - gold


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, V) logits against (B, S) ids, averaged over the mask
    (``sum / max(mask.sum(), 1)``) or over every position."""
    nll_ = nll(logits, targets)
    if mask is not None:
        return (nll_ * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll_.mean()
