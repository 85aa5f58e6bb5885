"""The port's ssm family (rwkv6) held to the JAX package on the CPU: forward,
prefill with its recurrent cache, one-token decode, the layernorm it uses,
and the full-width parameter count.

Weights are made once by the JAX init and carried to the port through numpy
(``convert.params_from_jax``), so both packages compute on the same numbers.
On CPU tensors ``attn_impl="kernel"`` runs the wkv scan's plain version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models import rwkv6 as jrwkv6
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import convert, layers, registry, rwkv6

ARCH = "rwkv6-3b"
F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
IMPLS = ["ref", "kernel"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _assert_logits_close(out, ref):
    """Within 1e-5 of the logits' largest magnitude: float32 sums in another
    order move single logits by up to 1.5e-5 at |logit| <= 4.5."""
    ref = np.asarray(ref)
    assert np.abs(np.asarray(out) - ref).max() <= 1e-5 * np.abs(ref).max()


def _cfgs(**over):
    over = {**F32, **over}
    return jax_smoke(ARCH).replace(**over), get_smoke_config(ARCH).replace(**over)


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    jcfg, cfg = _cfgs()
    jparams = jax.tree.map(np.asarray, jax.jit(functools.partial(jregistry.init_params, jcfg))(
        jax.random.PRNGKey(seed)))
    return jparams, convert.params_from_jax(cfg, jparams)


def _tokens(b, s, seed=1):
    _, cfg = _cfgs()
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jax_cache_layers(cfg, jcache):
    """JAX's run-stacked cache -> the port's per-layer list of numpy dicts."""
    flat = convert.params_from_jax(cfg, jax.tree.map(np.asarray, {"head": {}, "runs": jcache}))
    return [{k: v.numpy() for k, v in layer.items()} for layer in flat["layers"]]


def _assert_cache_equal(cache, jcache_layers, **tol):
    assert len(cache) == len(jcache_layers)
    for ours, theirs in zip(cache, jcache_layers):
        assert set(ours) == set(theirs) == {"S", "tshift", "cshift"}
        for k in ours:
            np.testing.assert_allclose(ours[k].numpy(), theirs[k], **tol)


def test_layernorm_matches_jax():
    g = np.random.default_rng(0)
    x = (g.standard_normal((3, 5, 48)) * 3 + 1).astype(np.float32)
    s, b = (g.standard_normal(48).astype(np.float32) for _ in range(2))
    ref = jlayers.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-6)
    out = layers.layernorm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    xb = torch.from_numpy(x).bfloat16()
    assert layers.layernorm(xb, torch.from_numpy(s), torch.from_numpy(b)).dtype == torch.bfloat16


def test_full_width_param_count():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (32, 2560, 8960, 65_536)
    assert registry.param_count(cfg) == 3_099_691_520


def test_init_matches_jax_shapes_dtypes_and_constants():
    _, cfg = _cfgs()
    jparams, _ = _params()
    ours = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    mine = rwkv6.init_params(cfg.replace(param_dtype="bfloat16"), device="cpu", seed=3)

    def shapes(tree, path=""):
        if isinstance(tree, torch.Tensor):
            return {path: tuple(tree.shape)}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items for k, v in shapes(sub, f"{path}/{key}").items()}
    assert shapes(mine) == shapes(ours)
    assert all(t.dtype == torch.bfloat16 for t in registry.leaves(mine))
    tm = mine["layers"][0]["tm"]
    assert torch.equal(tm["w0"], ours["layers"][0]["tm"]["w0"].bfloat16())
    assert (tm["mu"] == 0.5).all() and (tm["gn_scale"] == 1).all()
    assert 0.05 < tm["u"].float().std().item() < 0.2          # normal * 0.1


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(impl):
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    toks = _tokens(2, 24)
    jlg, _ = jax.jit(functools.partial(jregistry.forward, jcfg))(jparams,
                                                                 {"tokens": jnp.asarray(toks)})
    lg, aux = registry.forward(cfg.replace(attn_impl=impl), params,
                               {"tokens": torch.from_numpy(toks)})
    assert lg.shape == (2, 24, cfg.vocab_size) and aux == {}
    _assert_logits_close(lg.numpy(), jlg)


def test_kernel_path_on_cpu_equals_ref_path():
    _, cfg = _cfgs()
    _, params = _params()
    toks = torch.from_numpy(_tokens(2, 37))
    lk, _ = registry.forward(cfg.replace(attn_impl="kernel"), params, {"tokens": toks})
    lr, _ = registry.forward(cfg.replace(attn_impl="ref"), params, {"tokens": toks})
    assert torch.equal(lk, lr)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_then_decode_match_jax_cache_included(impl):
    """Prefill of 32 tokens (a multiple of 16: JAX's padding fault stays out of
    the way) with every cache entry, then 3 decode steps."""
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    toks = _tokens(2, 35, seed=2)
    jlg, jc = jax.jit(functools.partial(jregistry.prefill, jcfg))(
        jparams, jregistry.init_cache(jcfg, 2, 48), {"tokens": jnp.asarray(toks[:, :32])})
    cfg = cfg.replace(attn_impl=impl)
    cache = registry.init_cache(cfg, 2, 48, device="cpu")
    lg, c = registry.prefill(cfg, params, cache, {"tokens": torch.from_numpy(toks[:, :32])})
    assert c is cache and lg.shape == (2, 32, cfg.vocab_size)
    _assert_logits_close(lg.numpy(), jlg)
    _assert_cache_equal(cache, _jax_cache_layers(cfg, jc), **TOL)
    jstep = jax.jit(functools.partial(jregistry.decode_step, jcfg))
    for i in range(32, 35):
        pos = np.full((2,), i, np.int32)
        jlg, jc = jstep(jparams, jc, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos))
        lg, _ = registry.decode_step(cfg, params, cache, torch.from_numpy(toks[:, i:i + 1]),
                                     torch.from_numpy(pos))
        _assert_logits_close(lg.numpy(), jlg)
    _assert_cache_equal(cache, _jax_cache_layers(cfg, jc), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_from_a_nonzero_state_matches_jax_ref_branch(impl):
    """A cache holding state S: both of the port's branches carry it, as JAX's
    ref branch does (its Pallas branch drops it: ROADMAP Queue 3)."""
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    g = np.random.default_rng(4)
    jcache = jax.tree.map(lambda a: np.asarray(g.standard_normal(a.shape) * 0.5, a.dtype),
                          jregistry.init_cache(jcfg, 2, 16))
    toks = _tokens(2, 16, seed=5)
    jlg, jc = jregistry.prefill(jcfg, jparams, jax.tree.map(jnp.asarray, jcache),
                                {"tokens": jnp.asarray(toks)})
    cfg = cfg.replace(attn_impl=impl)
    cache = [{k: torch.from_numpy(v.copy()) for k, v in layer.items()}
             for layer in _jax_cache_layers(cfg, jcache)]
    lg, _ = registry.prefill(cfg, params, cache, {"tokens": torch.from_numpy(toks)})
    _assert_logits_close(lg.numpy(), jlg)
    _assert_cache_equal(cache, _jax_cache_layers(cfg, jc), **TOL)
    zero = registry.init_cache(cfg, 2, 16, device="cpu")
    lz, _ = registry.prefill(cfg, params, zero, {"tokens": torch.from_numpy(toks)})
    assert (lz - lg).abs().max() > 1e-3


def test_prefill_at_any_length_equals_decoding_token_by_token():
    """20 tokens (T % 16 != 0) through prefill leave the state that 20 decode
    steps leave, and the decode logits are the prefill's rows."""
    _, cfg = _cfgs(attn_impl="kernel")
    _, params = _params()
    toks = torch.from_numpy(_tokens(2, 20, seed=6))
    cache = registry.init_cache(cfg, 2, 20, device="cpu")
    lg, _ = registry.prefill(cfg, params, cache, {"tokens": toks})
    stepped = registry.init_cache(cfg, 2, 20, device="cpu")
    for i in range(20):
        ls, _ = registry.decode_step(cfg, params, stepped, toks[:, i:i + 1],
                                     torch.full((2,), i, dtype=torch.int32))
        np.testing.assert_allclose(ls[:, 0].numpy(), lg[:, i].numpy(), rtol=1e-4, atol=1e-4)
    for ours, ref in zip(cache, stepped):
        np.testing.assert_allclose(ours["S"].numpy(), ref["S"].numpy(), rtol=1e-4, atol=1e-5)


def test_reset_slot_zeroes_one_row_of_the_recurrent_cache():
    _, cfg = _cfgs()
    cache = registry.init_cache(cfg, 3, 8, device="cpu")
    for layer in cache:
        for t in layer.values():
            t.fill_(1.0)
    registry.reset_slot(cfg, cache, 1)
    for layer in cache:
        for t in layer.values():
            assert (t[1] == 0).all() and (t[0] == 1).all() and (t[2] == 1).all()
    dense = get_smoke_config("gemma3-4b")
    kv = registry.init_cache(dense, 2, 8, device="cpu")
    for layer in kv:
        for t in layer.values():
            t.fill_(1.0)
    registry.reset_slot(dense, kv, 0)     # attention caches are left as they are
    assert all((t == 1).all() for layer in kv for t in layer.values())
