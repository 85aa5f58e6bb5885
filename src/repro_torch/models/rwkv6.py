"""RWKV-6 "Finch", family ``ssm`` (attention-free, data-dependent decay): init,
forward, prefill, recurrent cache, one-token decode.

Counterpart of ``repro.models.rwkv6``.  The full-sequence path (``forward``,
``prefill``) runs the wkv recurrence in chunks of 16: with
``attn_impl="kernel"`` through the hand-written kernel
``repro_torch.kernels.rwkv6_scan`` (K4), else through its plain version.
Both carry the input state (the JAX package's Pallas branch drops it; ROADMAP
Queue 3).  Decode is the plain one-token recurrence ``wkv_step``, as in the
JAX package.  Params and cache are flat per-layer lists as in
``models.transformer``; a layer's cache is ``{"S": (B, H, D, D) float32,
"tshift": (B, d), "cshift": (B, d)}``, updated in place by ``prefill`` and
``decode_step``.  ``reset_slot`` zeroes one serving slot's state.

wkv head state: S in (B, H, Dk, Dv);   S_t = diag(w_t) S_{t-1} + k_t^T v_t
                y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_ref
from repro_torch.models import head, layers, stack

LORA_MIX = 32
LORA_DECAY = 64
LOGW_MIN = -8.0
LOGW_MAX = -1e-4


def _dims(cfg: ModelConfig) -> tuple[int, int]:
    return cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def layer_init(cfg: ModelConfig, gen, device, kind: str) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    h, dh = _dims(cfg)
    pd = cfg.pdtype

    def full(shape, value):
        return torch.full(shape, value, dtype=pd, device=device)

    def normal(shape, scale):
        return (layers._normal(gen, shape, device) * scale).to(pd)

    tm = {
        "mu_x": full((d,), 0.5),
        "mu": full((5, d), 0.5),
        "w1": layers.dense_init(gen, d, 5 * LORA_MIX, pd, device),
        "w2": normal((5, LORA_MIX, d), 0.01),
        "w0": torch.linspace(-5.0, -3.0, d, dtype=torch.float32, device=device).to(pd),
        "wa": layers.dense_init(gen, d, LORA_DECAY, pd, device),
        "wb": normal((LORA_DECAY, d), 0.01),
        "u": normal((h, dh), 0.1),
        "wr": layers.dense_init(gen, d, d, pd, device),
        "wk": layers.dense_init(gen, d, d, pd, device),
        "wv": layers.dense_init(gen, d, d, pd, device),
        "wg": layers.dense_init(gen, d, d, pd, device),
        "wo": layers.dense_init(gen, d, d, pd, device),
        "gn_scale": full((d,), 1.0),
        "gn_bias": full((d,), 0.0),
    }
    cm = {
        "mu_k": full((d,), 0.5),
        "mu_r": full((d,), 0.5),
        "wk": layers.dense_init(gen, d, dff, pd, device),
        "wv": layers.dense_init(gen, dff, d, pd, device),
        "wr": layers.dense_init(gen, d, d, pd, device),
    }
    return {"ln1": full((d,), 0.0), "tm": tm, "ln2": full((d,), 0.0), "cm": cm}


# ---------------------------------------------------------------------------
# time mix
# ---------------------------------------------------------------------------


def _ddlerp(p, x, xprev):
    """Data-dependent token-shift mixing -> (x_w, x_k, x_v, x_r, x_g)."""
    sx = xprev - x
    xxx = x + sx * p["mu_x"].to(x.dtype)
    t = torch.tanh(xxx @ p["w1"].to(x.dtype))
    t = t.reshape(*t.shape[:-1], 5, LORA_MIX)
    m = torch.einsum("bsfr,frd->bsfd", t, p["w2"].to(x.dtype))
    mixed = x[..., None, :] + sx[..., None, :] * (p["mu"].to(x.dtype) + m)
    return [mixed[..., i, :] for i in range(5)]


def _rkvwg(cfg: ModelConfig, p, x, xprev):
    xw, xk, xv, xr, xg = _ddlerp(p, x, xprev)
    cd = cfg.cdtype
    r = xr @ p["wr"].to(cd)
    k = xk @ p["wk"].to(cd)
    v = xv @ p["wv"].to(cd)
    g = F.silu(xg @ p["wg"].to(cd))
    logw = -torch.exp(p["w0"].float()
                      + torch.tanh(xw @ p["wa"].to(cd)).float() @ p["wb"].float())
    logw = logw.clamp(LOGW_MIN, LOGW_MAX)
    return r, k, v, g, logw


def _heads(x, h, dh):
    return x.reshape(*x.shape[:-1], h, dh)


def wkv_step(r, k, v, logw, u, state):
    """Single-token recurrence. r/k/v: (B,H,D); state (B,H,Dk,Dv) fp32."""
    r, k, v = r.float(), k.float(), v.float()
    kv = k[..., :, None] * v[..., None, :]                    # (B,H,Dk,Dv)
    y = torch.einsum("bhd,bhdv->bhv", r, state + u[..., None] * kv)
    state = torch.exp(logw)[..., None] * state + kv
    return y, state


def _group_norm(y, scale, bias, eps):
    """Per-head layernorm over D (GroupNorm(H)); y: (B,S,H,D) fp32."""
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + eps)
    b, s, h, d = y.shape
    y = y.reshape(b, s, h * d)
    return y * scale.float() + bias.float()


def time_mix(cfg: ModelConfig, p, x, xprev, state):
    """x: (B,S,d); xprev: token-shifted x; state: (B,H,D,D) fp32 or None
    (zero).  -> (out (B,S,d), final state)."""
    h, dh = _dims(cfg)
    r, k, v, g, logw = _rkvwg(cfg, p, x, xprev)
    scan = rwkv6_scan if cfg.attn_impl == "kernel" else rwkv6_scan_ref
    y, state = scan(_heads(r, h, dh), _heads(k, h, dh), _heads(v, h, dh),
                    _heads(logw, h, dh), p["u"].float(), state)
    y = _group_norm(y, p["gn_scale"], p["gn_bias"], cfg.norm_eps)
    y = y.to(cfg.cdtype) * g
    return y @ p["wo"].to(cfg.cdtype), state


def channel_mix(cfg: ModelConfig, p, x, xprev):
    cd = cfg.cdtype
    xk = x + (xprev - x) * p["mu_k"].to(x.dtype)
    xr = x + (xprev - x) * p["mu_r"].to(x.dtype)
    kk = torch.square(F.relu(xk @ p["wk"].to(cd)))
    vv = kk @ p["wv"].to(cd)
    rr = torch.sigmoid(xr @ p["wr"].to(cd))
    return rr * vv


def _tshift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _ln(x, scale, eps):
    return layers.layernorm(x, 1.0 + scale, torch.zeros_like(scale), eps)


def layer_apply(cfg: ModelConfig, p, x, *, window, kind):
    xa = _ln(x, p["ln1"], cfg.norm_eps)
    y, _ = time_mix(cfg, p["tm"], xa, _tshift(xa), None)
    x = x + y
    xb = _ln(x, p["ln2"], cfg.norm_eps)
    return x + channel_mix(cfg, p["cm"], xb, _tshift(xb))


# -- decode ----------------------------------------------------------------------


def layer_cache_shape(cfg: ModelConfig, batch: int) -> dict:
    h, dh = _dims(cfg)
    return {"S": ((batch, h, dh, dh), torch.float32),
            "tshift": ((batch, cfg.d_model), cfg.cdtype),
            "cshift": ((batch, cfg.d_model), cfg.cdtype)}


def layer_decode(cfg: ModelConfig, p, cache, x, pos, *, window, kind):
    h, dh = _dims(cfg)
    xa = _ln(x, p["ln1"], cfg.norm_eps)
    xprev = cache["tshift"][:, None, :]
    r, k, v, g, logw = _rkvwg(cfg, p["tm"], xa, xprev)
    y, S = wkv_step(_heads(r[:, 0], h, dh), _heads(k[:, 0], h, dh),
                    _heads(v[:, 0], h, dh), _heads(logw[:, 0], h, dh),
                    p["tm"]["u"].float(), cache["S"])
    y = _group_norm(y[:, None], p["tm"]["gn_scale"], p["tm"]["gn_bias"], cfg.norm_eps)
    y = y.to(cfg.cdtype) * g
    x = x + y @ p["tm"]["wo"].to(cfg.cdtype)
    xb = _ln(x, p["ln2"], cfg.norm_eps)
    cprev = cache["cshift"][:, None, :]
    x = x + channel_mix(cfg, p["cm"], xb, cprev)
    cache["S"].copy_(S)
    cache["tshift"].copy_(xa[:, 0])
    cache["cshift"].copy_(xb[:, 0])
    return x, cache


def layer_prefill(cfg: ModelConfig, p, cache, x, *, window, kind):
    """The full sequence from the cache's state S (the token shifts start
    from zero, as in the JAX package); the cache is overwritten in place."""
    xa = _ln(x, p["ln1"], cfg.norm_eps)
    y, S = time_mix(cfg, p["tm"], xa, _tshift(xa), cache["S"])
    x = x + y
    xb = _ln(x, p["ln2"], cfg.norm_eps)
    x = x + channel_mix(cfg, p["cm"], xb, _tshift(xb))
    cache["S"].copy_(S)
    cache["tshift"].copy_(xa[:, -1])
    cache["cshift"].copy_(xb[:, -1])
    return x, cache


# -- model --------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, device: torch.device, seed: int = 0) -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    meta device takes none: it only counts shapes)."""
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    return {"head": head.init(cfg, gen, device),
            "layers": [layer_init(cfg, gen, device, kind)
                       for _, kind in stack.layer_sigs(cfg)]}


def _hidden(cfg: ModelConfig, params, batch):
    x = head.embed(cfg, params["head"], batch["tokens"])
    apply = stack.maybe_remat(cfg, layer_apply)
    for (window, kind), p in zip(stack.layer_sigs(cfg), params["layers"]):
        x = apply(cfg, p, x, window=window, kind=kind)
    return x


def forward(cfg: ModelConfig, params, batch):
    """batch: {"tokens": (B, S)} -> (logits, aux dict)."""
    return head.logits(cfg, params["head"], _hidden(cfg, params, batch)), {}


def loss_fn(cfg: ModelConfig, params, batch):
    """batch: {"tokens", "targets" (B, S), "loss_mask" (optional)} -> (loss, {})."""
    return head.chunked_loss(cfg, params["head"], _hidden(cfg, params, batch), batch), {}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: torch.device) -> list[dict]:
    """The recurrent state: its size does not depend on ``seq_len``."""
    return [{name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in layer_cache_shape(cfg, batch).items()}
            for _ in range(cfg.num_layers)]


def reset_slot(cache: list[dict], slot: int) -> None:
    """Zero batch row ``slot`` of every layer's state, in place."""
    for layer in cache:
        for t in layer.values():
            t[slot].zero_()


def prefill(cfg: ModelConfig, params, cache, batch):
    """The prompt through every layer from the cache's state -> (logits,
    cache overwritten in place)."""
    x = head.embed(cfg, params["head"], batch["tokens"])
    for (window, kind), p, c in zip(stack.layer_sigs(cfg), params["layers"], cache):
        x, _ = layer_prefill(cfg, p, c, x, window=window, kind=kind)
    return head.logits(cfg, params["head"], x), cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """tokens: (B, 1); pos unused (the state holds the history) -> (logits, cache)."""
    x = head.embed(cfg, params["head"], tokens)
    for (window, kind), p, c in zip(stack.layer_sigs(cfg), params["layers"], cache):
        x, _ = layer_decode(cfg, p, c, x, pos, window=window, kind=kind)
    return head.logits(cfg, params["head"], x), cache
