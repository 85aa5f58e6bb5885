"""Mixture-of-Experts family (DeepSeekMoE / DeepSeek-V2-Lite): init, forward,
prefill, cache, one-token decode.

Counterpart of ``repro.models.moe``.  The FFN is
``num_shared_experts`` dense shared experts plus ``num_experts`` routed
experts with top-k gating, routed one of two ways (``cfg.moe_impl``):

* ``dispatch`` (the default, and what serving uses): GShard one-hot
  dispatch/combine products over (E, C) capacity buffers;
* ``ragged``: tokens sorted by expert id and scattered into the same buffers.

Both run the experts through ``_expert_ffn``, which with
``attn_impl="kernel"`` calls the grouped expert-FFN kernel once per dispatch
group (one group at decode, and up to ``MOE_GROUP`` tokens in a forward or
prefill).  Attention is MHA (``models.attention``) or MLA
(``models.mla``) when ``cfg.use_mla``.  Params and cache are flat per-layer
lists as in ``models.transformer``; ``stack.layer_kinds`` makes the first
``first_dense_layers`` layers dense and the rest moe.  Capacities and group
sizes are Python ints, so routing needs no host sync.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gemm import moe_expert_ffn
from repro_torch.models import attention, head, layers, mla, stack

MOE_GROUP = 4096  # tokens per dispatch group

# ---------------------------------------------------------------------------
# routed experts
# ---------------------------------------------------------------------------


def moe_init(cfg: ModelConfig, gen, device) -> dict:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff

    def experts(in_dim, out_dim):
        # drawn (in, E, out) as the JAX package draws them, then laid out
        # (E, in, out) contiguous, which the kernel reads
        w = layers.dense_init(gen, in_dim, (e, out_dim), cfg.pdtype, device)
        return w.transpose(0, 1).contiguous()

    p = {"router": layers.dense_init(gen, d, e, torch.float32, device),
         "wi_gate": experts(d, f), "wi_up": experts(d, f), "wo": experts(f, d)}
    if cfg.num_shared_experts:
        p["shared"] = layers.swiglu_init(gen, d, cfg.num_shared_experts * f, cfg.pdtype, device)
    return p


def _route(cfg: ModelConfig, p, xg):
    """xg: (n, G, d) -> (probs (n,G,K), ids (n,G,K) int64, aux scalar)."""
    logits = xg.float() @ p["router"]
    probs_full = torch.softmax(logits, dim=-1)
    probs, ids = torch.topk(probs_full, cfg.top_k, dim=-1)
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux (Switch/GShard): E * mean_e(frac_tokens_e * mean_prob_e)
    e = cfg.num_experts
    assign = F.one_hot(ids, e).float().sum(2)                          # (n,G,E)
    frac = assign.mean((0, 1)) / cfg.top_k
    mean_p = probs_full.mean((0, 1))
    aux = e * torch.sum(frac * mean_p) * cfg.aux_loss_coef
    return probs, ids, aux


def _capacity(cfg: ModelConfig, g: int) -> int:
    c = int(g * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8


def _expert_ffn(cfg: ModelConfig, p, xe):
    """xe: (n, E, C, d) -> (n, E, C, d)."""
    cd = cfg.cdtype
    wg, wu, wo = (p[k].to(cd) for k in ("wi_gate", "wi_up", "wo"))
    if cfg.attn_impl == "kernel":
        # one kernel call per dispatch group
        return torch.stack([moe_expert_ffn(xg.contiguous(), wg, wu, wo) for xg in xe])
    gate = torch.einsum("necd,edf->necf", xe, wg)
    up = torch.einsum("necd,edf->necf", xe, wu)
    return torch.einsum("necf,efd->necd", F.silu(gate) * up, wo)


def _moe_dispatch(cfg: ModelConfig, p, xg, probs, ids):
    """GShard one-hot dispatch. xg: (n,G,d)."""
    g = xg.shape[1]
    e, c = cfg.num_experts, _capacity(cfg, g)
    onehot = F.one_hot(ids, e).float()                                 # (n,G,K,E)
    assign = onehot.sum(2)                                             # (n,G,E)
    pos = torch.cumsum(assign, 1) - assign                             # (n,G,E)
    keep = (pos < c).float() * assign
    # jax.nn.one_hot gives a zero row for pos >= c where F.one_hot raises:
    # clamp the index, and keep zeroes those rows
    disp = keep[..., None] * F.one_hot(pos.long().clamp(max=c - 1), c).float()
    gates = (onehot * probs[..., None]).sum(2)                         # (n,G,E)
    combine = disp * gates[..., None]                                  # (n,G,E,C)
    xe = torch.einsum("ngec,ngd->necd", disp.to(cfg.cdtype), xg)       # (n,E,C,d)
    ye = _expert_ffn(cfg, p, xe)
    return torch.einsum("ngec,necd->ngd", combine.to(cfg.cdtype), ye)


def _moe_ragged(cfg: ModelConfig, p, xg, probs, ids):
    """Sort-based dispatch. xg: (n,G,d).

    Tokens past an expert's capacity are dropped.  They are scattered into an
    extra slot C that is cut off before the experts run, so every kept token
    lands in its own slot.  (The JAX package clamps them onto slot C-1 and
    writes zeros there, which can erase the token kept in that slot; the two
    differ only when tokens are dropped, and this one equals ``dispatch``.)
    """
    n, g, d = xg.shape
    e, k, c = cfg.num_experts, cfg.top_k, _capacity(cfg, g)
    dev = xg.device
    eid = ids.reshape(n, g * k)                                        # (n, GK)
    tok = torch.arange(g, device=dev).repeat_interleave(k).expand(n, g * k)
    pw = probs.reshape(n, g * k)

    order = torch.argsort(eid, dim=-1, stable=True)
    eid_s = eid.gather(-1, order)
    tok_s = tok.gather(-1, order)
    pw_s = pw.gather(-1, order)
    # rank within expert segment
    seg_start = torch.searchsorted(eid_s, torch.arange(e, device=dev).expand(n, e).contiguous())
    slot = torch.arange(g * k, device=dev) - seg_start.gather(-1, eid_s)
    keep = slot < c
    slot = torch.where(keep, slot, c)

    nidx = torch.arange(n, device=dev)[:, None].expand(n, g * k)
    xe = xg.new_zeros((n, e, c + 1, d))
    xe[nidx, eid_s, slot] = xg[nidx, tok_s]
    ye = _expert_ffn(cfg, p, xe[:, :, :c])                             # (n,E,C,d)
    back = ye[nidx, eid_s, slot.clamp(max=c - 1)]                      # (n,GK,d)
    back = back * (pw_s * keep)[..., None].to(back.dtype)
    out = torch.zeros_like(xg)
    out.index_put_((nidx, tok_s), back, accumulate=True)
    return out


def moe_ffn(cfg: ModelConfig, p, x):
    """x: (B,S,d) -> (out, aux)."""
    b, s, d = x.shape
    tokens = b * s
    g = min(MOE_GROUP, tokens)
    while tokens % g != 0:
        g -= 1
    xg = x.reshape(tokens // g, g, d)
    probs, ids, aux = _route(cfg, p, xg)
    impl = _moe_ragged if cfg.moe_impl == "ragged" else _moe_dispatch
    out = impl(cfg, p, xg, probs, ids).reshape(b, s, d)
    if cfg.num_shared_experts:
        out = out + layers.swiglu_apply(p["shared"], x, cfg.cdtype)
    return out, aux


# ---------------------------------------------------------------------------
# layers / model
# ---------------------------------------------------------------------------


def layer_init(cfg: ModelConfig, gen, device, kind: str) -> dict:
    p = {"ln1": torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device),
         "ln2": torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device)}
    p["attn"] = (mla.init(cfg, gen, device) if cfg.use_mla
                 else attention.init(cfg, gen, device))
    if kind == "moe":
        p["moe"] = moe_init(cfg, gen, device)
    else:
        p["mlp"] = layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, device)
    return p


def _ffn(cfg: ModelConfig, p, h, kind):
    """-> (out, aux scalar); a dense layer has aux 0."""
    if kind == "moe":
        return moe_ffn(cfg, p["moe"], h)
    return (layers.swiglu_apply(p["mlp"], h, cfg.cdtype),
            torch.zeros((), dtype=torch.float32, device=h.device))


def layer_apply(cfg: ModelConfig, p, x, *, window, kind):
    """-> (x, aux scalar)."""
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        x = x + mla.apply(cfg, p["attn"], h)
    else:
        x = x + attention.apply(cfg, p["attn"], h, window=window)
    f, aux = _ffn(cfg, p, layers.rmsnorm(x, p["ln2"], cfg.norm_eps), kind)
    return x + f, aux


def layer_prefill(cfg: ModelConfig, p, cache, x, *, window, kind):
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, cache = mla.prefill(cfg, p["attn"], cache, h)
    else:
        a, cache = attention.prefill(cfg, p["attn"], cache, h, window=window)
    x = x + a
    f, _ = _ffn(cfg, p, layers.rmsnorm(x, p["ln2"], cfg.norm_eps), kind)
    return x + f, cache


def layer_decode(cfg: ModelConfig, p, cache, x, pos, *, window, kind):
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, cache = mla.decode(cfg, p["attn"], cache, h, pos)
    else:
        a, cache = attention.decode(cfg, p["attn"], cache, h, pos, window=window)
    x = x + a
    f, _ = _ffn(cfg, p, layers.rmsnorm(x, p["ln2"], cfg.norm_eps), kind)
    return x + f, cache


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
    """-> (hidden, the layers' aux terms summed, as ``stack.apply_runs_aux``)."""
    x = head.embed(cfg, params["head"], batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    apply = stack.maybe_remat(cfg, layer_apply)
    for (window, kind), p in zip(stack.layer_sigs(cfg), params["layers"]):
        x, a = apply(cfg, p, x, window=window, kind=kind)
        aux = aux + a
    return x, aux


def forward(cfg: ModelConfig, params, batch):
    """batch: {"tokens": (B, S)} -> (logits, {"moe_aux": aux})."""
    x, aux = _hidden(cfg, params, batch)
    return head.logits(cfg, params["head"], x), {"moe_aux": aux}


def loss_fn(cfg: ModelConfig, params, batch):
    """-> (cross entropy + the load-balance aux, {"moe_aux": aux})."""
    x, aux = _hidden(cfg, params, batch)
    return head.chunked_loss(cfg, params["head"], x, batch) + aux, {"moe_aux": aux}


def prefill(cfg: ModelConfig, params, cache, batch):
    """Batched prefill from position 0: forward + cache fill (in place)."""
    x = head.embed(cfg, params["head"], batch["tokens"])
    for (window, kind), p, c in zip(stack.layer_sigs(cfg), params["layers"], cache):
        x, _ = layer_prefill(cfg, p, c, x, window=window, kind=kind)
    return head.logits(cfg, params["head"], x), cache


def cache_shapes(cfg: ModelConfig, batch: int, seq_len: int) -> list[dict]:
    if cfg.use_mla:
        return [mla.cache_shape(cfg, batch, seq_len) for _ in range(cfg.num_layers)]
    return [dict.fromkeys(("k", "v"), attention.cache_shape(cfg, batch, seq_len, w))
            for w in stack.layer_windows(cfg)]


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: torch.device) -> list[dict]:
    return [{name: torch.zeros(s, dtype=cfg.cdtype, device=device) for name, s in c.items()}
            for c in cache_shapes(cfg, batch, seq_len)]


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """tokens: (B, 1); pos: (B,) int32 absolute positions. -> (logits, cache)."""
    x = head.embed(cfg, params["head"], tokens)
    for (window, kind), p, c in zip(stack.layer_sigs(cfg), params["layers"], cache):
        x, _ = layer_decode(cfg, p, c, x, pos, window=window, kind=kind)
    return head.logits(cfg, params["head"], x), cache
