"""Hymba, family ``hybrid``: every layer runs an attention head-group and a
Mamba (selective SSM) head-group in parallel on the same normed input; their
normalized outputs are averaged, then a SwiGLU FFN.

Counterpart of ``repro.models.hymba``.  Full attention only in
``cfg.full_attn_layers``, a sliding window elsewhere; ``num_meta_tokens``
learnable meta tokens are prepended to the sequence, so they take positions
[0, M) and a decode at ``pos`` runs at ``pos + M``.  The attention branch goes
through ``models.attention``: with ``attn_impl="kernel"`` the full-sequence
path runs the flash-attention kernel (K2) on every layer and decode the
decode-attention kernel (K1) on the full-cache layers.  The Mamba branch is
plain torch: ``selective_scan`` is a per-token loop in float32, as the JAX
package's ``lax.scan`` is (no Pallas kernel there).

Params are a flat per-layer list as in ``models.transformer`` plus the
top-level ``meta`` (M, d).  A layer's cache is ``{"k", "v"}`` (full or ring,
over ``seq_len + M`` positions), ``"ssm_h"`` (B, di, N) float32 and
``"conv"`` (B, k-1, di) in the compute dtype, updated in place by ``prefill``
and ``decode_step``.  As in the JAX package, ``prefill`` starts the Mamba
branch from a zero state whatever the cache holds.  ``reset_slot`` zeroes one
serving slot's ``ssm_h`` and ``conv`` and leaves the attention caches alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import local_map, shard
from repro_torch.models import attention, head, layers, stack

# tokens per block of selective_scan's precomputed decays and inputs (memory only)
SCAN_BLOCK = 256


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    di = cfg.ssm_expand * cfg.d_model
    dt_rank = -(-cfg.d_model // 16)
    return di, dt_rank, cfg.ssm_state, cfg.ssm_conv


# ---------------------------------------------------------------------------
# mamba branch
# ---------------------------------------------------------------------------


def mamba_init(cfg: ModelConfig, gen, device) -> dict:
    d = cfg.d_model
    di, dt_rank, n, k = _dims(cfg)
    pd = cfg.pdtype
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": layers.dense_init(gen, d, 2 * di, pd, device),
        "conv_w": (layers._normal(gen, (k, di), device) * 0.1).to(pd),
        "conv_b": torch.zeros((di,), dtype=pd, device=device),
        "x_proj": layers.dense_init(gen, di, dt_rank + 2 * n, pd, device),
        "dt_proj": layers.dense_init(gen, dt_rank, di, pd, device),
        "dt_bias": torch.full((di,), -4.6, dtype=pd, device=device),   # softplus^-1(0.01)
        "A_log": torch.log(a.repeat(di, 1)).to(pd),
        "D": torch.ones((di,), dtype=pd, device=device),
        "out_proj": layers.dense_init(gen, di, d, pd, device),
    }


def mamba_specs(cfg: ModelConfig) -> dict:
    return {
        "in_proj": ("embed", "ffn"), "conv_w": (None, "ffn"), "conv_b": ("ffn",),
        "x_proj": ("ffn", None), "dt_proj": (None, "ffn"), "dt_bias": ("ffn",),
        "A_log": ("ffn", None), "D": ("ffn",), "out_proj": ("ffn", "embed"),
    }


def _conv1d(xin, w, b, conv_state=None):
    """Causal depthwise conv.  xin: (B, S, di); w: (k, di).  conv_state
    (B, k-1, di), if given, is the left context (decode).  -> (out, the last
    k-1 inputs as the next state)."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xin.shape[0], k - 1, xin.shape[2]), dtype=xin.dtype,
                          device=xin.device)
    else:
        pad = conv_state.to(xin.dtype)
    xp = torch.cat([pad, xin], dim=1)                     # (B, S+k-1, di)
    s = xin.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(k))
    return out + b, xp[:, -(k - 1):]


def _ssm_params(cfg: ModelConfig, p, xc):
    _, dt_rank, n, _ = _dims(cfg)
    # held whole over "model" (the product contracts the sharded channels)
    # before its split: the card's torch finds no strategy for the split
    # partial sums' next product
    xdb = shard(xc @ p["x_proj"].to(xc.dtype), "batch", None, None)
    dt_raw, b_, c_ = torch.split(xdb, [dt_rank, n, n], dim=-1)
    dt = F.softplus((dt_raw @ p["dt_proj"].to(xc.dtype)).float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())                    # (di, N)
    return dt, a, b_.float(), c_.float()


def selective_scan(dt, a, b_, c_, xc, d_skip, h0):
    """dt: (B, S, di) fp32; a: (di, N); b_/c_: (B, S, N) fp32; xc: (B, S, di);
    h0: (B, di, N) fp32.  -> (y (B, S, di) fp32, the last h).

    One token at a time, h = exp(dt a) h + (dt x) b, y = h . c, as the JAX
    package's scan; the per-token decays and inputs are computed a block of
    SCAN_BLOCK tokens at a time, so each token's update is one launch.  It
    writes each state into a preallocated block (``out=``), which autograd
    refuses: when autograd records, each update makes a new state and the
    block is stacked from them (one launch a token still, plus a copy a
    block)."""
    xf = xc.float()
    h = h0
    record = layers.grad_needed(dt, a, b_, c_, xf, d_skip, h0)
    ys = []
    for s0 in range(0, dt.shape[1], SCAN_BLOCK):
        # time-major blocks, so that token t's slices are contiguous
        dt_t = dt[:, s0:s0 + SCAN_BLOCK].transpose(0, 1)
        x_t = xf[:, s0:s0 + SCAN_BLOCK].transpose(0, 1)
        b_t = b_[:, s0:s0 + SCAN_BLOCK].transpose(0, 1)
        c_t = c_[:, s0:s0 + SCAN_BLOCK].transpose(0, 1)
        da = torch.exp(dt_t[..., None] * a)                           # (s, B, di, N)
        dbx = (dt_t * x_t)[..., None] * b_t[:, :, None, :]
        if record:
            states = []
            for t in range(da.shape[0]):
                h = torch.addcmul(dbx[t], da[t], h)
                states.append(h)
            hs = torch.stack(states)
        else:
            hs = torch.empty_like(da)
            for t in range(da.shape[0]):
                h = torch.addcmul(dbx[t], da[t], h, out=hs[t])
        ys.append(torch.einsum("sbdn,sbn->bsd", hs, c_t))
    y = torch.cat(ys, dim=1) + xf * d_skip
    return y, h


def mamba_apply(cfg: ModelConfig, p, x, h0=None, conv_state=None):
    """x: (B, S, d) -> (y (B, S, d), (h, conv_state))."""
    di, _, n, _ = _dims(cfg)
    cd = cfg.cdtype
    xin, z = torch.chunk(x @ p["in_proj"].to(cd), 2, dim=-1)
    xin = shard(xin, "batch", None, "ffn")
    xc, conv_state = _conv1d(xin, p["conv_w"].to(cd), p["conv_b"].to(cd), conv_state)
    xc = F.silu(xc)
    dt, a, b_, c_ = _ssm_params(cfg, p, xc)
    if h0 is None:
        h0 = torch.zeros((x.shape[0], di, n), dtype=torch.float32, device=x.device)
    # per batch row and channel: on DTensors the scan runs on the local shards
    bsf, bfn, bsn = ("batch", None, "ffn"), ("batch", "ffn", None), ("batch", None, None)
    y, h = local_map(selective_scan, [bsf, ("ffn", None), bsn, bsn, bsf, ("ffn",), bfn],
                     [(bsf, tuple(dt.shape)), (bfn, tuple(h0.shape))],
                     dt, a, b_, c_, xc, p["D"].float(), h0)
    y = shard(y.to(cd) * F.silu(z), "batch", None, "ffn")
    return y @ p["out_proj"].to(cd), (h, conv_state)


# ---------------------------------------------------------------------------
# fused layer
# ---------------------------------------------------------------------------


def layer_init(cfg: ModelConfig, gen, device, kind: str) -> dict:
    def zeros():
        return torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device)
    return {
        "ln1": zeros(),
        "attn": attention.init(cfg, gen, device),
        "mamba": mamba_init(cfg, gen, device),
        "norm_attn": zeros(),
        "norm_ssm": zeros(),
        "ln2": zeros(),
        "mlp": layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, device),
    }


def layer_specs(cfg: ModelConfig, kind: str) -> dict:
    return {
        "ln1": (None,), "attn": attention.specs(cfg), "mamba": mamba_specs(cfg),
        "norm_attn": (None,), "norm_ssm": (None,),
        "ln2": (None,), "mlp": layers.swiglu_specs(),
    }


def layer_cache_specs(cfg: ModelConfig, kind):
    s = attention.cache_specs(cfg)
    s["ssm_h"] = ("batch", "ffn", None)
    s["conv"] = ("batch", None, "ffn")
    return s


def _fuse_and_ffn(cfg: ModelConfig, p, x, a, m):
    """x + the averaged normed branch outputs, then the SwiGLU FFN."""
    fused = 0.5 * (layers.rmsnorm(a, p["norm_attn"], cfg.norm_eps)
                   + layers.rmsnorm(m, p["norm_ssm"], cfg.norm_eps))
    x = shard(x + fused, "batch", None, "embed")
    h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return shard(x + layers.swiglu_apply(p["mlp"], h, cfg.cdtype), "batch", None, "embed")


def layer_apply(cfg: ModelConfig, p, x, *, window, kind):
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a = attention.apply(cfg, p["attn"], h, window=window)
    m, _ = mamba_apply(cfg, p["mamba"], h)
    return _fuse_and_ffn(cfg, p, x, a, m)


def layer_decode(cfg: ModelConfig, p, cache, x, pos, *, window, kind):
    """One token; ``cache`` (k, v, ssm_h, conv) is updated in place."""
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, _ = attention.decode(cfg, p["attn"], cache, h, pos, window=window)
    m, (ssm_h, conv) = mamba_apply(cfg, p["mamba"], h, h0=cache["ssm_h"],
                                   conv_state=cache["conv"])
    cache["ssm_h"].copy_(ssm_h)
    cache["conv"].copy_(conv)
    return _fuse_and_ffn(cfg, p, x, a, m), cache


def layer_prefill(cfg: ModelConfig, p, cache, x, *, window, kind):
    """The full sequence; the Mamba branch starts from zero, as in the JAX
    package, and the cache is overwritten in place."""
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, _ = attention.prefill(cfg, p["attn"], cache, h, window=window)
    m, (ssm_h, conv) = mamba_apply(cfg, p["mamba"], h)
    cache["ssm_h"].copy_(ssm_h)
    cache["conv"].copy_(conv)
    return _fuse_and_ffn(cfg, p, x, a, m), cache


# -- model --------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, device: torch.device, seed: int = 0) -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    meta device takes none: it only counts shapes)."""
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    p = {"head": head.init(cfg, gen, device),
         "layers": [layer_init(cfg, gen, device, kind) for _, kind in stack.layer_sigs(cfg)]}
    if cfg.num_meta_tokens:
        p["meta"] = (layers._normal(gen, (cfg.num_meta_tokens, cfg.d_model), device)
                     * 0.02).to(cfg.pdtype)
    return p


def _embed_with_meta(cfg: ModelConfig, params, tokens):
    x = head.embed(cfg, params["head"], tokens)
    if cfg.num_meta_tokens:
        meta = params["meta"].to(cfg.cdtype).expand(x.shape[0], -1, -1)
        x = torch.cat([meta, x], dim=1)
    return x


def param_specs(cfg: ModelConfig) -> dict:
    s = {"head": head.specs(cfg), "layers": stack.run_specs(cfg, layer_specs)}
    if cfg.num_meta_tokens:
        s["meta"] = (None, "embed")
    return s


def cache_specs(cfg: ModelConfig) -> list:
    return stack.cache_run_specs(cfg, layer_cache_specs)


def _hidden(cfg: ModelConfig, params, batch):
    x = _embed_with_meta(cfg, params, batch["tokens"])
    apply = stack.maybe_remat(cfg, layer_apply)
    for (window, kind), p in zip(stack.layer_sigs(cfg), params["layers"]):
        x = apply(cfg, p, x, window=window, kind=kind)
    return x[:, cfg.num_meta_tokens:]


def forward(cfg: ModelConfig, params, batch):
    """batch: {"tokens": (B, S)} -> (logits over the token positions, aux dict)."""
    return head.logits(cfg, params["head"], _hidden(cfg, params, batch)), {}


def loss_fn(cfg: ModelConfig, params, batch):
    """batch: {"tokens", "targets" (B, S), "loss_mask" (optional)} -> (loss, {})."""
    return head.chunked_loss(cfg, params["head"], _hidden(cfg, params, batch), batch), {}


def layer_cache_shape(cfg: ModelConfig, window, batch: int, seq_len: int) -> dict:
    di, _, n, k = _dims(cfg)
    kv = attention.cache_shape(cfg, batch, seq_len + cfg.num_meta_tokens, window)
    return {"k": (kv, cfg.cdtype), "v": (kv, cfg.cdtype),
            "ssm_h": ((batch, di, n), torch.float32),
            "conv": ((batch, k - 1, di), cfg.cdtype)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: torch.device) -> list[dict]:
    return [{name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in layer_cache_shape(cfg, w, batch, seq_len).items()}
            for w in stack.layer_windows(cfg)]


def reset_slot(cache: list[dict], slot: int) -> None:
    """Zero batch row ``slot`` of every layer's Mamba state, in place; the
    attention caches are masked by position and are left as they are."""
    for layer in cache:
        layer["ssm_h"][slot].zero_()
        layer["conv"][slot].zero_()


def prefill(cfg: ModelConfig, params, cache, batch):
    """The meta tokens and the prompt from position 0 -> (logits over the
    prompt, cache overwritten in place)."""
    x = _embed_with_meta(cfg, params, batch["tokens"])
    for (window, kind), p, c in zip(stack.layer_sigs(cfg), params["layers"], cache):
        x, _ = layer_prefill(cfg, p, c, x, window=window, kind=kind)
    return head.logits(cfg, params["head"], x[:, cfg.num_meta_tokens:]), cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """tokens: (B, 1); pos: (B,) int32 token positions, offset by the meta
    prefix here -> (logits, cache)."""
    x = head.embed(cfg, params["head"], tokens)
    pos = pos + cfg.num_meta_tokens
    for (window, kind), p, c in zip(stack.layer_sigs(cfg), params["layers"], cache):
        x, _ = layer_decode(cfg, p, c, x, pos, window=window, kind=kind)
    return head.logits(cfg, params["head"], x), cache
