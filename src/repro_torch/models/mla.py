"""Multi-head Latent Attention (DeepSeek-V2): init, expanded-KV apply/prefill,
absorbed one-token decode.

Counterpart of ``repro.models.mla`` (``_dims``, ``init``, ``_latent``,
``_queries``, ``apply``, ``prefill``, ``cache_shape``, ``decode``).  The
full-sequence path expands the latent into per-head K (qk 192 = nope 128 +
rope 64) and V (128) and runs the plain ``layers.attention`` (dv != d), as
the JAX package does: no kernel.  The cache holds only the normalised latent
``ckv`` (B, T, r) and the roped shared key ``krope`` (B, T, dr) per token,
with no head axis; ``prefill`` and ``decode`` write it in place.  No kernel
is involved: the scores are plain products.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers
from repro_torch.models.layers import NEG_INF


def _dims(cfg: ModelConfig):
    return (cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim)


def init(cfg: ModelConfig, gen, device) -> dict:
    h, r, dn, dr, dv = _dims(cfg)
    pd = cfg.pdtype
    return {
        "wdkv": layers.dense_init(gen, cfg.d_model, r + dr, pd, device),
        "kv_norm": torch.zeros((r,), dtype=pd, device=device),
        "wq": layers.dense_init(gen, cfg.d_model, (h, dn + dr), pd, device),
        "wuk": layers.dense_init(gen, r, (h, dn), pd, device),
        "wuv": layers.dense_init(gen, r, (h, dv), pd, device),
        "wo": layers.dense_init(gen, h * dv, cfg.d_model, pd, device).reshape(h, dv, cfg.d_model),
    }


def _latent(cfg: ModelConfig, p, x, positions):
    """-> ckv (B,S,r) normalised, k_rope (B,S,1,dr) roped."""
    r = cfg.kv_lora_rank
    ckv_full = x @ p["wdkv"].to(cfg.cdtype)
    ckv, k_rope = ckv_full[..., :r], ckv_full[..., r:]
    ckv = layers.rmsnorm(ckv, p["kv_norm"], cfg.norm_eps)
    k_rope = layers.apply_rope(k_rope[..., None, :], positions, cfg.rope_theta)
    return ckv, k_rope


def _queries(cfg: ModelConfig, p, x, positions):
    dn = cfg.qk_nope_head_dim
    q = attention._proj(x, p["wq"], cfg.cdtype)                     # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _expanded_attention(cfg: ModelConfig, p, x, positions, ckv, k_rope):
    """Attention over the expanded latent: per-head K = [ckv W_uk, k_rope],
    V = ckv W_uv, through the plain ``layers.attention``."""
    h, r, dn, dr, dv = _dims(cfg)
    cd = cfg.cdtype
    b, s, _ = x.shape
    q_nope, q_rope = _queries(cfg, p, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["wuk"].to(cd))
    v = torch.einsum("bsr,rhk->bshk", ckv, p["wuv"].to(cd))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    out = layers.attention(q, k, v, causal=True, window=None, q_block=min(512, s))
    return attention._out_proj(cfg, p, out)


def apply(cfg: ModelConfig, p, x, *, positions=None) -> torch.Tensor:
    """Training / forward path (expanded KV). x: (B,S,d)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    ckv, k_rope = _latent(cfg, p, x, positions)
    return _expanded_attention(cfg, p, x, positions, ckv, k_rope)


def prefill(cfg: ModelConfig, p, cache: dict, x):
    """Full-sequence forward from position 0 that also fills the latent cache
    at [0, min(S, T)), in place; returns (out, the same cache dict)."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    ckv, k_rope = _latent(cfg, p, x, positions)
    out = _expanded_attention(cfg, p, x, positions, ckv, k_rope)
    n = min(s, cache["ckv"].shape[1])
    cache["ckv"][:, :n] = ckv[:, :n]
    cache["krope"][:, :n] = k_rope[:, :n, 0]
    return out, cache


def cache_shape(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    _, r, _, dr, _ = _dims(cfg)
    return {"ckv": (batch, seq_len, r), "krope": (batch, seq_len, dr)}


def decode(cfg: ModelConfig, p, cache: dict, x, pos):
    """x: (B,1,d); pos: (B,) int32.  Absorbed-MLA single-token attention.

    Returns (out, cache); ``cache`` is updated in place (the JAX package
    returns new arrays) and is the same dict.
    """
    h, r, dn, dr, dv = _dims(cfg)
    cd = cfg.cdtype
    b = x.shape[0]
    ckv_new, krope_new = _latent(cfg, p, x, pos[:, None])
    bidx = torch.arange(b, device=x.device)
    ckv, krope = cache["ckv"], cache["krope"]
    ckv.index_put_((bidx, pos.long()), ckv_new[:, 0])
    krope.index_put_((bidx, pos.long()), krope_new[:, 0, 0])

    q_nope, q_rope = _queries(cfg, p, x, pos[:, None])
    # absorb W_uk: q_nope . k_nope = (q_nope @ W_uk^T) . ckv
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"].to(cd))
    # float32 scores, as the JAX einsums' preferred_element_type
    scores = torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
    scores = scores + torch.einsum("bshk,btk->bhst", q_rope.float(), krope.float())
    scores = scores / math.sqrt(dn + dr)

    t = ckv.shape[1]
    mask = torch.arange(t, device=x.device)[None, :] <= pos[:, None]   # (B, T)
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs, ckv.float())
    out = torch.einsum("bshr,rhk->bshk", ctx.to(cd), p["wuv"].to(cd))
    return attention._out_proj(cfg, p, out), cache
