"""GQA attention block: init, full-sequence apply/prefill, one-token decode.

Counterpart of ``repro.models.attention`` (``init``, ``_project_qkv``,
``_attn_core``, ``apply``, ``cache_shape``, ``prefill``, ``decode``).  With
``attn_impl="kernel"`` the full-sequence attention runs the flash-attention
kernel and decode on full-cache layers the decode-attention kernel; both run
their plain versions on CPU tensors.

Cache layouts
-------------
* global layers: full cache  k,v: (B, T, K, D); new tokens written at ``pos``.
* local (sliding window) layers: ring cache k,v: (B, W, K, D); slot = pos % W.
  Slot s holds position p - ((p - s) mod W); unwritten slots map to negative
  positions and are masked.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers
from repro_torch.models.layers import NEG_INF


def init(cfg: ModelConfig, gen, device) -> dict:
    h, k_, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = cfg.pdtype
    p = {
        "wq": layers.dense_init(gen, cfg.d_model, (h, d), pd, device),
        "wk": layers.dense_init(gen, cfg.d_model, (k_, d), pd, device),
        "wv": layers.dense_init(gen, cfg.d_model, (k_, d), pd, device),
        "wo": layers.dense_init(gen, h * d, cfg.d_model, pd, device).reshape(h, d, cfg.d_model),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((d,), dtype=pd, device=device)
        p["k_norm"] = torch.zeros((d,), dtype=pd, device=device)
    return p


def _proj(x, w, cd):
    # "bsd,dhk->bshk" as one (B*S, d) x (d, H*D) product
    d_in, nh, hd = w.shape
    return (x @ w.to(cd).reshape(d_in, nh * hd)).unflatten(-1, (nh, hd))


def _project_qkv(cfg: ModelConfig, p, x, positions):
    cd = cfg.cdtype
    q = _proj(x, p["wq"], cd)
    k = _proj(x, p["wk"], cd)
    v = _proj(x, p["wv"], cd)
    if cfg.qk_norm:   # before RoPE, as in the JAX package
        q = layers.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_core(cfg: ModelConfig, q, k, v, *, causal: bool, window, q_offset: int = 0):
    """The flash-attention kernel (``attn_impl="kernel"``; it takes any S and
    T, so there is no block-size search) or the plain ``layers.attention``."""
    if cfg.attn_impl == "kernel":
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=cfg.attn_logit_softcap, q_offset=q_offset)
    return layers.attention(q, k, v, causal=causal, window=window,
                            logit_softcap=cfg.attn_logit_softcap,
                            q_block=min(512, q.shape[1]), q_offset=q_offset,
                            score_dtype=getattr(torch, cfg.attn_scores_dtype))


def _out_proj(cfg: ModelConfig, p, out):
    wo = p["wo"].to(cfg.cdtype)
    return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])            # "bshk,hkd->bsd"


def apply(cfg: ModelConfig, p, x, *, window: Optional[int], positions=None,
          causal: bool = True) -> torch.Tensor:
    """Training / forward path. x: (B, S, d)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project_qkv(cfg, p, x, positions)
    return _out_proj(cfg, p, _attn_core(cfg, q, k, v, causal=causal, window=window))


def prefill(cfg: ModelConfig, p, cache: dict, x, *, window: Optional[int]):
    """Full-sequence forward from position 0 that also fills the KV cache.

    x: (B, S, d).  The full cache gets k/v at [0, min(S, T)); a ring cache
    (T = W slots) gets the last min(W, S) tokens at slot position % W.  The
    cache is written in place (the JAX package returns new arrays) and the
    same dict is returned.
    """
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = _attn_core(cfg, q, k, v, causal=True, window=window)
    t = cache["k"].shape[1]
    if window is None:
        n = min(s, t)
        cache["k"][:, :n] = k[:, :n]
        cache["v"][:, :n] = v[:, :n]
    else:
        w = min(t, s)
        slots = torch.arange(s - w, s, device=x.device) % t
        cache["k"][:, slots] = k[:, s - w:]
        cache["v"][:, slots] = v[:, s - w:]
    return _out_proj(cfg, p, out), cache


def cache_shape(cfg: ModelConfig, batch: int, seq_len: int,
                window: Optional[int]) -> tuple[int, ...]:
    t = seq_len if window is None else min(window, seq_len)
    return (batch, t, cfg.num_kv_heads, cfg.head_dim)


def decode(cfg: ModelConfig, p, cache: dict, x, pos, *, window: Optional[int]):
    """One-token decode. x: (B, 1, d); pos: (B,) int32. Returns (out, cache).

    The new key/value are written into ``cache`` in place (the JAX package
    donates the cache buffer instead), and the same dict is returned.
    """
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(cfg, p, x, pos[:, None])
    k, v = cache["k"], cache["v"]
    t = k.shape[1]
    slot = pos.long() if window is None else (pos % t).long()
    bidx = torch.arange(b, device=x.device)
    k.index_put_((bidx, slot), k_new[:, 0])
    v.index_put_((bidx, slot), v_new[:, 0])

    if window is None and cfg.attn_impl == "kernel":
        out = decode_attention(q, k, v, pos, softcap=cfg.attn_logit_softcap).to(cfg.cdtype)
    else:
        key_idx = torch.arange(t, device=x.device)
        if window is None:
            # full cache: positions are 0..t-1; mask future
            mask = key_idx[None, :] <= pos[:, None]
        else:
            # ring cache: slot s holds position p - ((p - s) mod W)
            kpos = pos[:, None] - torch.remainder(pos[:, None] - key_idx[None, :], t)
            mask = kpos >= 0
        scores = layers._gqa_scores(q, k, cfg.attn_logit_softcap)   # (B,K,G,1,T)
        scores = scores.masked_fill(~mask[:, None, None, None, :], NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = layers._gqa_out(probs, v).to(cfg.cdtype)               # (B,1,H,D)
    return _out_proj(cfg, p, out), cache
