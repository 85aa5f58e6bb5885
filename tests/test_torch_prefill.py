"""The port's full-sequence path (attention/MLA apply and prefill, the dense,
vlm and moe forward and prefill) held to the JAX package on the CPU.

Inputs and weights are made once (numpy seeds, JAX init) and carried to the
port through numpy, so both packages compute on the same numbers.  On CPU
tensors ``attn_impl="kernel"`` runs the kernels' plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattention
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, convert, mla, moe, registry

F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
ARCHS = ["gemma3-4b", "internvl2-76b", "deepseek-moe-16b", "deepseek-v2-lite-16b"]
IMPLS = ["ref", "kernel"]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(tree)


def _jax_init(init, jcfg, seed):
    """JAX init under one jit (eager init compiles op by op), as numpy."""
    tree = jax.jit(functools.partial(init, jcfg))(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, tree)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _cfgs(arch, **over):
    over = {**F32, "capacity_factor": 64.0, **over}
    return jax_smoke(arch).replace(**over), get_smoke_config(arch).replace(**over)


def _batch(cfg, b, s, seed=1):
    r = _rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = r.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _params(arch, seed=0):
    jcfg, cfg = _cfgs(arch)
    jparams = _jax_init(jregistry.init_params, jcfg, seed)
    return jparams, convert.params_from_jax(cfg, jparams)


def _cache_np(cache):
    return [{k: v.numpy().copy() for k, v in layer.items()} for layer in cache]


# -- attention.apply / prefill -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _attn_params():
    jcfg, _ = _cfgs("gemma3-4b")
    return _jax_init(jattention.init, jcfg, 1)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("window", [None, 8])
def test_attention_apply_matches_jax(window, impl):
    jcfg, cfg = _cfgs("gemma3-4b", attn_impl=impl)
    jp = _attn_params()
    x = _rng(2).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    ref = jattention.apply(jcfg, jp, jnp.asarray(x), window=window)
    out = attention.apply(cfg, _tree(jp), _t(x), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("window,s,t", [
    (None, 12, 32),      # full cache, S < T
    (None, 24, 16),      # full cache shorter than the prompt: [0, T) filled
    (8, 6, 8),           # ring cache, S < W
    (8, 24, 8),          # ring cache, S > W: the last 8 tokens at pos % 8
])
def test_attention_prefill_matches_jax_cache_included(window, s, t, impl):
    jcfg, cfg = _cfgs("gemma3-4b", attn_impl=impl)
    jp = _attn_params()
    r = _rng(3)
    x = r.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    shp = (2, t, cfg.num_kv_heads, cfg.head_dim)
    ck, cv = (r.standard_normal(shp).astype(np.float32) for _ in range(2))   # stale contents
    jout, jc = jattention.prefill(jcfg, jp, {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                                  jnp.asarray(x), window=window)
    cache = {"k": _t(ck), "v": _t(cv)}
    out, c = attention.prefill(cfg, _tree(jp), cache, _t(x), window=window)
    assert c is cache    # filled in place
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), rtol=1e-5, atol=1e-5)


# -- MLA ------------------------------------------------------------------------------


def test_mla_apply_and_prefill_match_jax():
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    jp = _jax_init(jmla.init, jcfg, 1)
    p = _tree(jp)
    r = _rng(4)
    x = r.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    ref = jmla.apply(jcfg, jp, jnp.asarray(x))
    out = mla.apply(cfg, p, _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for t in (32, 12):      # a cache longer and shorter than the prompt
        ckv = r.standard_normal((2, t, cfg.kv_lora_rank)).astype(np.float32)
        krope = r.standard_normal((2, t, cfg.qk_rope_head_dim)).astype(np.float32)
        jout, jc = jmla.prefill(jcfg, jp, {"ckv": jnp.asarray(ckv),
                                           "krope": jnp.asarray(krope)}, jnp.asarray(x))
        cache = {"ckv": _t(ckv), "krope": _t(krope)}
        out, c = mla.prefill(cfg, p, cache, _t(x))
        assert c is cache
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
        for k in ("ckv", "krope"):
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), rtol=1e-5, atol=1e-5)


# -- moe -------------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,cf,groups", [(2, 2048, 1.25, 1), (4, 2048, 0.25, 2)])
def test_moe_ffn_at_full_dispatch_groups_matches_jax(b, s, cf, groups):
    """B x S = 4096 tokens is one dispatch group of MOE_GROUP (the chip's
    deepseek-moe-16b prefill, B 2 S 2048); 8192 tokens are two."""
    jcfg, cfg = _cfgs("deepseek-moe-16b", capacity_factor=cf)
    jp = _jax_init(jmoe.moe_init, jcfg, 0)
    x = _rng(5).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    assert b * s // moe.MOE_GROUP == groups
    assert moe._capacity(cfg, moe.MOE_GROUP) == jmoe._capacity(jcfg, moe.MOE_GROUP)
    ref, jaux = jax.jit(functools.partial(jmoe.moe_ffn, jcfg))(jp, jnp.asarray(x))
    out, aux = moe.moe_ffn(cfg.replace(attn_impl="kernel"), _tree(jp), _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)


# -- the whole model: forward and prefill ----------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg):
    return jax.jit(functools.partial(jregistry.forward, jcfg))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, impl):
    jcfg, cfg = _cfgs(arch)
    jparams, params = _params(arch)
    batch = _batch(cfg, 2, 24)
    jlg, jaux = _jax_forward(jcfg)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    lg, aux = registry.forward(cfg.replace(attn_impl=impl), params, _tbatch(batch))
    assert lg.shape == (2, 24, cfg.vocab_size)
    assert _rel_err(lg.numpy(), jlg) <= 1e-4
    assert set(aux) == set(jaux)
    if "moe_aux" in aux:
        np.testing.assert_allclose(aux["moe_aux"].item(), float(jaux["moe_aux"]), rtol=1e-4)


def test_moe_forward_with_dropped_tokens_matches_jax():
    """capacity_factor 0.5: experts drop tokens; dispatch drops the same ones."""
    jcfg, cfg = _cfgs("deepseek-moe-16b", capacity_factor=0.5)
    jparams, params = _params("deepseek-moe-16b")
    batch = _batch(cfg, 2, 24, seed=2)
    assert moe._capacity(cfg, 48) < 48 * cfg.top_k / cfg.num_experts
    jlg, jaux = _jax_forward(jcfg)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    lg, aux = registry.forward(cfg.replace(attn_impl="kernel"), params, _tbatch(batch))
    assert _rel_err(lg.numpy(), jlg) <= 1e-4
    np.testing.assert_allclose(aux["moe_aux"].item(), float(jaux["moe_aux"]), rtol=1e-4)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax_cache_included(arch, impl):
    jcfg, cfg = _cfgs(arch)
    jparams, params = _params(arch)
    batch = _batch(cfg, 2, 20)
    total = 32 + (cfg.num_patches if cfg.family == "vlm" else 0)   # > window 16 (gemma3)
    jlg, jcache = jax.jit(functools.partial(jregistry.prefill, jcfg))(
        jparams, jregistry.init_cache(jcfg, 2, total),
        {k: jnp.asarray(v) for k, v in batch.items()})
    cache = registry.init_cache(cfg, 2, total, device="cpu")
    lg, c = registry.prefill(cfg.replace(attn_impl=impl), params, cache, _tbatch(batch))
    assert c is cache and lg.shape == (2, 20, cfg.vocab_size)
    assert _rel_err(lg.numpy(), jlg) <= 1e-4
    jflat = convert.params_from_jax(cfg, jax.tree.map(np.asarray, {"head": {},
                                                                  "runs": jcache}))["layers"]
    assert len(jflat) == len(cache) == cfg.num_layers
    for ours, theirs in zip(_cache_np(cache), jflat):
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k].numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Inside the port (tests/test_models.py::test_prefill_decode_matches_forward):
    prefill the first half, decode the rest one token at a time, and hold every
    logit to the forward over the whole sequence."""
    _, cfg = _cfgs(arch, attn_impl="kernel")
    _, params = _params(arch)
    b, s = 2, 24
    batch = _tbatch(_batch(cfg, b, s))
    toks = batch["tokens"]
    full, _ = registry.forward(cfg, params, batch)
    scale = full.abs().max().item() + 1e-9

    half = s // 2
    pre = dict(batch, tokens=toks[:, :half])
    off = cfg.num_patches if cfg.family == "vlm" else 0
    cache = registry.init_cache(cfg, b, s + off, device="cpu")
    lg, cache = registry.prefill(cfg, params, cache, pre)
    assert (lg - full[:, :half]).abs().max().item() / scale < 1e-4
    for t in range(half, s):
        lg, cache = registry.decode_step(cfg, params, cache, toks[:, t:t + 1],
                                         torch.full((b,), t + off, dtype=torch.int32))
        err = (lg[:, 0] - full[:, t]).abs().max().item() / scale
        assert err < 1e-4, (arch, t, err)


@pytest.mark.parametrize("arch,per_prefill", [("gemma3-4b", 6), ("internvl2-76b", 2),
                                              ("deepseek-moe-16b", 3),
                                              ("deepseek-v2-lite-16b", 0)])
def test_kernel_impl_calls_flash_attention_once_per_mha_layer(arch, per_prefill, monkeypatch):
    """Under attn_impl="kernel" every MHA/GQA layer's attention goes through
    the flash-attention wrapper (local and global alike); MLA never does."""
    _, cfg = _cfgs(arch, attn_impl="kernel")
    _, params = _params(arch)
    calls = []
    fa = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append(kw.get("window")) or fa(*a, **kw))
    batch = _tbatch(_batch(cfg, 2, 20))
    registry.forward(cfg, params, batch)
    cache = registry.init_cache(cfg, 2, 40, device="cpu")
    registry.prefill(cfg, params, cache, batch)
    assert len(calls) == 2 * per_prefill
    if arch == "gemma3-4b":
        assert calls[:6] == [16] * 5 + [None]


def test_convert_carries_vlm_trees_through_the_dense_path():
    jcfg, cfg = _cfgs("internvl2-76b", num_layers=4)
    jparams = _jax_init(jregistry.init_params, jcfg, 3)
    params = convert.params_from_jax(cfg, jparams)
    ours = registry.init_params(cfg, device="meta")
    assert len(params["layers"]) == 4
    assert (jax.tree.map(lambda t: (tuple(t.shape), t.dtype), params)
            == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), ours))
    assert registry.param_count(cfg) == jcfg.param_count()
