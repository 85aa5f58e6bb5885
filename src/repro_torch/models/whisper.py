"""Whisper-style encoder-decoder, family ``encdec``: init, encoder, forward,
cross and self caches, prefill, one-token decode.

Counterpart of ``repro.models.whisper``.  The audio frontend is a stub:
``batch["enc_embeds"]`` holds precomputed frame embeddings (B, frames, d).
Absolute sinusoidal positions, a bidirectional encoder, a causal decoder with
cross-attention, no RoPE.  Every attention is the plain
``layers.attention`` / ``_gqa_scores`` path, as in the JAX package: this
family reaches no kernel.

Params are ``{"head", "enc": [layer, ...], "dec": [layer, ...], "enc_norm"}``
(the JAX package stacks ``enc`` and ``dec`` with a leading layer axis; see
``models.convert``).  The cache is a per-decoder-layer list of
``{"self_k", "self_v", "cross_k", "cross_v"}``, each (B, T or frames, H, D)
in the compute dtype, written in place by ``prefill_cross``, ``prefill`` and
``decode_step``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import div_axis, shard
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, head, layers, stack
from repro_torch.models.layers import NEG_INF

# -- small building blocks ----------------------------------------------------


def _attn_init(cfg: ModelConfig, gen, device) -> dict:
    h, d, dm = cfg.num_heads, cfg.head_dim, cfg.d_model
    pd = cfg.pdtype
    return {
        "wq": layers.dense_init(gen, dm, (h, d), pd, device),
        "wk": layers.dense_init(gen, dm, (h, d), pd, device),
        "wv": layers.dense_init(gen, dm, (h, d), pd, device),
        "wo": layers.dense_init(gen, h * d, dm, pd, device).reshape(h, d, dm),
    }


def _attn_specs(cfg: ModelConfig) -> dict:
    qh = div_axis("heads", cfg.num_heads)
    return {"wq": ("embed", qh, None), "wk": ("embed", qh, None),
            "wv": ("embed", qh, None), "wo": (qh, None, "embed")}


def _mlp_init(cfg: ModelConfig, gen, device) -> dict:
    return {"w1": layers.dense_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, device),
            "w2": layers.dense_init(gen, cfg.d_ff, cfg.d_model, cfg.pdtype, device)}


def _mlp_specs() -> dict:
    return {"w1": ("embed", "ffn"), "w2": ("ffn", "embed")}


def _mlp(p, x, cd):
    # jax.nn.gelu's default is the tanh approximation
    h = shard(F.gelu(x @ p["w1"].to(cd), approximate="tanh"), "batch", None, "ffn")
    return h @ p["w2"].to(cd)


def _proj_qkv(cfg: ModelConfig, p, xq, xkv):
    cd = cfg.cdtype
    return (attention._proj(xq, p["wq"], cd), attention._proj(xkv, p["wk"], cd),
            attention._proj(xkv, p["wv"], cd))


def _attn(cfg: ModelConfig, p, xq, xkv, *, causal: bool):
    q, k, v = _proj_qkv(cfg, p, xq, xkv)
    out = layers.attention(q, k, v, causal=causal, window=None,
                           q_block=min(512, q.shape[1]))
    return attention._out_proj(cfg, p, out)


def _attn_kv(cfg: ModelConfig, p, xq, k, v):
    """Cross-attention of xq against a cached k, v."""
    q = attention._proj(xq, p["wq"], cfg.cdtype)
    out = layers.attention(q, k, v, causal=False, window=None,
                           q_block=min(512, q.shape[1]))
    return attention._out_proj(cfg, p, out)


def _pos(cfg: ModelConfig, seq: int, device):
    return layers.sinusoidal_pos(seq, cfg.d_model, device).to(cfg.cdtype)


# -- layers and params ----------------------------------------------------------


def _norm_init(cfg: ModelConfig, device) -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device)


def enc_layer_init(cfg: ModelConfig, gen, device) -> dict:
    return {"ln1": _norm_init(cfg, device), "attn": _attn_init(cfg, gen, device),
            "ln2": _norm_init(cfg, device), "mlp": _mlp_init(cfg, gen, device)}


def dec_layer_init(cfg: ModelConfig, gen, device) -> dict:
    return {"ln1": _norm_init(cfg, device), "self": _attn_init(cfg, gen, device),
            "lnx": _norm_init(cfg, device), "cross": _attn_init(cfg, gen, device),
            "ln2": _norm_init(cfg, device), "mlp": _mlp_init(cfg, gen, device)}


def enc_layer_specs(cfg: ModelConfig) -> dict:
    return {"ln1": (None,), "attn": _attn_specs(cfg), "ln2": (None,), "mlp": _mlp_specs()}


def dec_layer_specs(cfg: ModelConfig) -> dict:
    return {"ln1": (None,), "self": _attn_specs(cfg), "lnx": (None,),
            "cross": _attn_specs(cfg), "ln2": (None,), "mlp": _mlp_specs()}


def param_specs(cfg: ModelConfig) -> dict:
    """The JAX package's tree with the leading "layers" axis of ``enc`` and
    ``dec`` dropped: one spec tree a layer (``stack.run_specs``)."""
    return {"head": head.specs(cfg),
            "enc": [enc_layer_specs(cfg) for _ in range(cfg.num_encoder_layers)],
            "dec": [dec_layer_specs(cfg) for _ in range(cfg.num_layers)],
            "enc_norm": (None,)}


def init_params(cfg: ModelConfig, *, device: torch.device, seed: int = 0) -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    meta device takes none: it only counts shapes)."""
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    return {"head": head.init(cfg, gen, device),
            "enc": [enc_layer_init(cfg, gen, device) for _ in range(cfg.num_encoder_layers)],
            "dec": [dec_layer_init(cfg, gen, device) for _ in range(cfg.num_layers)],
            "enc_norm": _norm_init(cfg, device)}


def encode(cfg: ModelConfig, params, enc_embeds):
    """enc_embeds: (B, frames, d) -> the encoder's output (B, frames, d).  On
    DTensors every residual is held to its spec after each block, as
    ``transformer.layer_decode``'s (JAX's whisper leaves the attention
    residuals to GSPMD)."""
    x = enc_embeds.to(cfg.cdtype)
    x = shard(x + _pos(cfg, x.shape[1], x.device), "batch", None, "embed")
    for p in params["enc"]:
        h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
        x = shard(x + _attn(cfg, p["attn"], h, h, causal=False), "batch", None, "embed")
        h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = shard(x + _mlp(p["mlp"], h, cfg.cdtype), "batch", None, "embed")
    return layers.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _embed(cfg: ModelConfig, params, tokens):
    x = head.embed(cfg, params["head"], tokens)
    return x + _pos(cfg, x.shape[1], x.device)


def _dec_layer(cfg: ModelConfig, p, x, enc_out):
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = shard(x + _attn(cfg, p["self"], h, h, causal=True), "batch", None, "embed")
    h = layers.rmsnorm(x, p["lnx"], cfg.norm_eps)
    x = shard(x + _attn(cfg, p["cross"], h, enc_out, causal=False), "batch", None, "embed")
    h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return shard(x + _mlp(p["mlp"], h, cfg.cdtype), "batch", None, "embed")


def _hidden(cfg: ModelConfig, params, batch):
    """The decoder's output.  Each decoder layer is checkpointed unless
    ``remat == "none"`` (``dots`` too checkpoints it whole, as the JAX
    package's ``jax.checkpoint`` of the decoder body does); the encoder is
    not."""
    enc_out = encode(cfg, params, batch["enc_embeds"])
    x = _embed(cfg, params, batch["tokens"])
    layer = stack.maybe_remat(cfg if cfg.remat == "none" else cfg.replace(remat="full"),
                              _dec_layer)
    for p in params["dec"]:
        x = layer(cfg, p, x, enc_out)
    return x


def forward(cfg: ModelConfig, params, batch):
    """batch: {"tokens": (B, S), "enc_embeds": (B, frames, d)} -> (logits, aux)."""
    return head.logits(cfg, params["head"], _hidden(cfg, params, batch)), {}


def loss_fn(cfg: ModelConfig, params, batch):
    """batch: {"tokens", "targets" (B, S), "loss_mask" (optional), "enc_embeds"}
    -> (loss, {})."""
    return head.chunked_loss(cfg, params["head"], _hidden(cfg, params, batch), batch), {}


# -- caches, prefill, decode ---------------------------------------------------------


def cache_specs(cfg: ModelConfig) -> list:
    qh = div_axis("heads", cfg.num_heads)
    s = ("batch", None, qh, None)
    return [dict.fromkeys(("self_k", "self_v", "cross_k", "cross_v"), s)
            for _ in range(cfg.num_layers)]


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: torch.device) -> list[dict]:
    def kv(t):
        return torch.zeros((batch, t, cfg.num_heads, cfg.head_dim), dtype=cfg.cdtype,
                           device=device)
    return [{"self_k": kv(seq_len), "self_v": kv(seq_len),
             "cross_k": kv(cfg.encoder_seq), "cross_v": kv(cfg.encoder_seq)}
            for _ in range(cfg.num_layers)]


def prefill_cross(cfg: ModelConfig, params, cache, enc_embeds):
    """Encode the audio and fill every layer's cross-attention cache in place."""
    enc_out = encode(cfg, params, enc_embeds)
    for p, c in zip(params["dec"], cache):
        c["cross_k"].copy_(attention._proj(enc_out, p["cross"]["wk"], cfg.cdtype))
        c["cross_v"].copy_(attention._proj(enc_out, p["cross"]["wv"], cfg.cdtype))
    return cache


def prefill(cfg: ModelConfig, params, cache, batch):
    """Encode the audio, fill the cross caches, and prefill the self caches
    with the prompt at positions [0, S) (zero past it, as the JAX package
    leaves them) -> (logits, cache filled in place)."""
    prefill_cross(cfg, params, cache, batch["enc_embeds"])
    x = _embed(cfg, params, batch["tokens"])
    s = x.shape[1]
    for p, c in zip(params["dec"], cache):
        h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _proj_qkv(cfg, p["self"], h, h)
        a = layers.attention(q, k, v, causal=True, window=None, q_block=min(512, s))
        x = shard(x + attention._out_proj(cfg, p["self"], a), "batch", None, "embed")
        h = layers.rmsnorm(x, p["lnx"], cfg.norm_eps)
        x = shard(x + _attn_kv(cfg, p["cross"], h, c["cross_k"], c["cross_v"]),
                  "batch", None, "embed")
        h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = shard(x + _mlp(p["mlp"], h, cfg.cdtype), "batch", None, "embed")
        n = min(s, c["self_k"].shape[1])
        for name, new in (("self_k", k), ("self_v", v)):
            c[name].zero_()
            sh.write_seq(c[name], new[:, :n], slice(0, n))
    return head.logits(cfg, params["head"], x), cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """tokens: (B, 1); pos: (B,) int32.  The self caches are updated in place;
    the cross caches are read only -> (logits, cache)."""
    t = cache[0]["self_k"].shape[1]
    x = head.embed(cfg, params["head"], tokens)
    pos = pos.long()
    x = x + _pos(cfg, t, x.device)[pos][:, None, :]

    hidden = torch.arange(t, device=x.device)[None, :] > pos[:, None]      # (B, T)

    def self_attn(q, k, v, hidden):
        scores = layers._gqa_scores(q, k, None).masked_fill(
            hidden[:, None, None, None, :], NEG_INF)
        return layers._gqa_out(layers.softmax(scores), v).to(cfg.cdtype)

    def cross_attn(q, k, v):
        scores = layers._gqa_scores(q, k, None)
        return layers._gqa_out(layers.softmax(scores), v).to(cfg.cdtype)

    for p, c in zip(params["dec"], cache):
        h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k_new, v_new = _proj_qkv(cfg, p["self"], h, h)
        sh.write_rows(c["self_k"], pos, k_new[:, 0])
        sh.write_rows(c["self_v"], pos, v_new[:, 0])
        a = layers.by_heads(self_attn, q, c["self_k"], c["self_v"], hidden,
                            rest_specs=[("batch", None)])
        x = shard(x + attention._out_proj(cfg, p["self"], a), "batch", None, "embed")
        h = layers.rmsnorm(x, p["lnx"], cfg.norm_eps)
        q = attention._proj(h, p["cross"]["wq"], cfg.cdtype)
        a = layers.by_heads(cross_attn, q, c["cross_k"], c["cross_v"])
        x = shard(x + attention._out_proj(cfg, p["cross"], a), "batch", None, "embed")
        h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
        # the residual held to its spec, as transformer.layer_decode
        x = shard(x + _mlp(p["mlp"], h, cfg.cdtype), "batch", None, "embed")
    return head.logits(cfg, params["head"], x), cache
