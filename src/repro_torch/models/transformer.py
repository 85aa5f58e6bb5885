"""Decoder-only transformer, families ``dense`` and ``vlm``: init, forward,
prefill, KV cache, one-token decode.

Counterpart of ``repro.models.transformer``.  Params are plain dicts of
tensors, ``{"head": {...}, "layers": [layer, ...]}`` with one dict per layer
(the JAX package stacks them into runs; see ``repro_torch.models.convert``),
and the layers run as a loop over that flat list.  The cache is a per-layer
list of ``{"k", "v"}`` tensors, filled in place by ``prefill`` and updated in
place by ``decode_step``.  vlm prepends ``num_patches`` precomputed patch
embeddings (``batch["patch_embeds"]``, a stub frontend) to the tokens; they
take positions [0, num_patches) and the logits cover the token positions.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models import attention, head, layers, stack


def layer_init(cfg: ModelConfig, gen, device, kind: str) -> dict:
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device),
        "attn": attention.init(cfg, gen, device),
        "ln2": torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device),
        "mlp": layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, device),
    }


def layer_specs(cfg: ModelConfig, kind: str) -> dict:
    return {
        "ln1": (None,),
        "attn": attention.specs(cfg),
        "ln2": (None,),
        "mlp": layers.swiglu_specs(),
    }


def layer_cache_specs(cfg: ModelConfig, kind):
    return attention.cache_specs(cfg)


def layer_apply(cfg: ModelConfig, p, x, *, window, kind, positions=None):
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + attention.apply(cfg, p["attn"], h, window=window, positions=positions)
    x = shard(x, "batch", None, "embed")
    h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return shard(x + layers.swiglu_apply(p["mlp"], h, cfg.cdtype), "batch", None, "embed")


def layer_prefill(cfg: ModelConfig, p, cache, x, *, window, kind):
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, cache = attention.prefill(cfg, p["attn"], cache, h, window=window)
    x = shard(x + a, "batch", None, "embed")
    h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return shard(x + layers.swiglu_apply(p["mlp"], h, cfg.cdtype), "batch", None, "embed"), cache


def layer_decode(cfg: ModelConfig, p, cache, x, pos, *, window, kind):
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, cache = attention.decode(cfg, p["attn"], cache, h, pos, window=window)
    # the residual held to its spec (the JAX package's decode leaves it to
    # GSPMD): DTensor would keep the sums over "model" partial and gather the
    # next layer's weights instead
    x = shard(x + a, "batch", None, "embed")
    h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = shard(x + layers.swiglu_apply(p["mlp"], h, cfg.cdtype), "batch", None, "embed")
    return x, cache


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


def _embed_inputs(cfg: ModelConfig, params, batch):
    x = head.embed(cfg, params["head"], batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embeds"].to(cfg.cdtype), x], dim=1)
    return x


def param_specs(cfg: ModelConfig) -> dict:
    return {"head": head.specs(cfg), "layers": stack.run_specs(cfg, layer_specs)}


def cache_specs(cfg: ModelConfig) -> list:
    return stack.cache_run_specs(cfg, layer_cache_specs)


def _hidden(cfg: ModelConfig, params, batch):
    x = _embed_inputs(cfg, params, batch)
    apply = stack.maybe_remat(cfg, layer_apply)
    for (window, kind), p in zip(stack.layer_sigs(cfg), params["layers"]):
        x = apply(cfg, p, x, window=window, kind=kind)
    return x[:, cfg.num_patches:] if cfg.family == "vlm" else x


def forward(cfg: ModelConfig, params, batch):
    """batch: {"tokens": (B, S)} (+ "patch_embeds" for vlm) -> (logits over
    token positions, aux dict)."""
    return head.logits(cfg, params["head"], _hidden(cfg, params, batch)), {}


def loss_fn(cfg: ModelConfig, params, batch):
    """batch: {"tokens", "targets" (B, S), "loss_mask" (optional)} (+
    "patch_embeds" for vlm) -> (loss over the token positions, {})."""
    return head.chunked_loss(cfg, params["head"], _hidden(cfg, params, batch), batch), {}


def prefill(cfg: ModelConfig, params, cache, batch):
    """Batched prefill from position 0: forward + cache fill (in place).
    For vlm, patch embeddings occupy positions [0, num_patches)."""
    x = _embed_inputs(cfg, params, batch)
    for (window, kind), p, c in zip(stack.layer_sigs(cfg), params["layers"], cache):
        x, _ = layer_prefill(cfg, p, c, x, window=window, kind=kind)
    if cfg.family == "vlm":
        x = x[:, cfg.num_patches:]
    return head.logits(cfg, params["head"], x), cache


def cache_shapes(cfg: ModelConfig, batch: int, seq_len: int) -> list[tuple[int, ...]]:
    return [attention.cache_shape(cfg, batch, seq_len, w)
            for w in stack.layer_windows(cfg)]


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: torch.device) -> list[dict]:
    return [{"k": torch.zeros(s, dtype=cfg.cdtype, device=device),
             "v": torch.zeros(s, dtype=cfg.cdtype, device=device)}
            for s in cache_shapes(cfg, batch, seq_len)]


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """tokens: (B, 1); pos: (B,) int32 absolute positions. -> (logits, cache)."""
    x = head.embed(cfg, params["head"], tokens)
    for (window, kind), p, c in zip(stack.layer_sigs(cfg), params["layers"], cache):
        x, _ = layer_decode(cfg, p, c, x, pos, window=window, kind=kind)
    return head.logits(cfg, params["head"], x), cache
