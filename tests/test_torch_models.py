"""The port's dense decode path held to the JAX package on the CPU.

Inputs and weights are made once (numpy seeds, JAX init) and carried to the
port through numpy, so both packages compute on the same numbers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattention
from repro.models import head as jhead
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention, convert, head, layers, registry, stack

F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_init(init, jcfg, seed):
    """JAX init under one jit (eager init compiles op by op), as numpy."""
    tree = jax.jit(functools.partial(init, jcfg))(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, tree)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


# -- building blocks -------------------------------------------------------------


def test_rmsnorm_matches_jax():
    x = _rng(0).standard_normal((2, 3, 64)).astype(np.float32)
    s = (_rng(1).standard_normal(64) * 0.1).astype(np.float32)
    ref = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    out = layers.rmsnorm(_t(x), _t(s), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_rope_matches_jax():
    x = _rng(2).standard_normal((2, 1, 4, 16)).astype(np.float32)
    pos = np.array([[3], [1000]], np.int32)
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    out = layers.apply_rope(_t(x), _t(pos), 1e6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_swiglu_matches_jax():
    r = _rng(3)
    p = {k: (r.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wi_gate", (32, 64)), ("wi_up", (32, 64)), ("wo", (64, 32)))}
    x = r.standard_normal((2, 1, 32)).astype(np.float32)
    ref = jlayers.swiglu_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), jnp.float32)
    out = layers.swiglu_apply({k: _t(v) for k, v in p.items()}, _t(x), torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_embed_and_logits_match_jax():
    jcfg = jax_smoke("gemma3-4b").replace(**F32)
    cfg = get_smoke_config("gemma3-4b").replace(**F32)
    jp = _jax_init(jhead.init, jcfg, 0)
    p = {k: _t(v) for k, v in jp.items()}
    tok = _rng(4).integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jx = jhead.embed(jcfg, jp, jnp.asarray(tok))
    x = head.embed(cfg, p, _t(tok))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    ref = jhead.logits(jcfg, jp, jx)
    out = head.logits(cfg, p, x)
    assert out.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 8])
def test_attention_decode_matches_jax(window):
    """Full cache and a ring of 8 slots that wraps (pos up to 21)."""
    jcfg = jax_smoke("gemma3-4b").replace(**F32)
    cfg = get_smoke_config("gemma3-4b").replace(**F32)
    jp = _jax_init(jattention.init, jcfg, 1)
    p = {k: _t(v) for k, v in jp.items()}
    r = _rng(5)
    t = 24 if window is None else window
    shp = (2, t, cfg.num_kv_heads, cfg.head_dim)
    ck, cv = (r.standard_normal(shp).astype(np.float32) for _ in range(2))
    x = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([5, 21], np.int32)
    jout, jc = jattention.decode(jcfg, jp, {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                                 jnp.asarray(x), jnp.asarray(pos), window=window)
    cache = {"k": _t(ck), "v": _t(cv)}
    out, c = attention.decode(cfg, p, cache, _t(x), _t(pos), window=window)
    assert c is cache    # updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c["v"].numpy(), np.asarray(jc["v"]), rtol=1e-5, atol=1e-5)


# -- the whole decode step ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jax.jit(functools.partial(jregistry.decode_step, jcfg))


@pytest.mark.parametrize("num_layers", [6, 14])
def test_decode_step_matches_jax_over_40_steps(num_layers):
    """40 steps, B=2 at unequal positions, max_seq 48 > window 16 so the ring
    caches wrap; logits held to JAX's ref and Pallas (interpret) paths."""
    over = dict(F32, num_layers=num_layers)
    jcfg = jax_smoke("gemma3-4b").replace(**over)
    cfg = get_smoke_config("gemma3-4b").replace(**over, attn_impl="kernel")
    runs = stack.compute_runs(cfg)
    assert [r.count for r in runs] == ([5, 1] if num_layers == 6 else [2, 2])
    jparams = _jax_init(jregistry.init_params, jcfg, 0)
    params = convert.params_from_jax(cfg, jparams)
    assert len(params["layers"]) == num_layers
    max_seq, steps = 48, 40
    pos0 = np.array([0, 7], np.int32)
    toks = _rng(6).integers(0, cfg.vocab_size, (steps, 2, 1)).astype(np.int32)

    jsteps = {impl: _jax_step(jcfg.replace(attn_impl=impl))
              for impl in ("ref", "pallas_interpret")}
    jcache = {impl: jregistry.init_cache(jcfg, 2, max_seq) for impl in jsteps}
    cache = registry.init_cache(cfg, 2, max_seq, device="cpu")
    worst = {impl: 0.0 for impl in jsteps}
    for s in range(steps):
        pos = pos0 + s
        lg, cache = registry.decode_step(cfg, params, cache, _t(toks[s]), _t(pos))
        for impl, fn in jsteps.items():
            jlg, jcache[impl] = fn(jparams, jcache[impl], jnp.asarray(toks[s]),
                                   jnp.asarray(pos))
            worst[impl] = max(worst[impl], _rel_err(lg.numpy(), jlg))
    assert max(pos0 + steps - 1) < max_seq
    for impl, err in worst.items():
        assert err <= 1e-4, (impl, err)


def test_kernel_impl_on_cpu_equals_ref():
    """attn_impl="kernel" on CPU tensors runs the plain version: same logits."""
    cfg = get_smoke_config("gemma3-4b").replace(**F32)
    params = registry.init_params(cfg, device="cpu", seed=3)
    toks = _rng(7).integers(0, cfg.vocab_size, (12, 2, 1)).astype(np.int32)
    out = {}
    for impl in ("ref", "kernel"):
        c = cfg.replace(attn_impl=impl)
        cache = registry.init_cache(c, 2, 32, device="cpu")
        for s in range(12):
            lg, cache = registry.decode_step(c, params, cache, _t(toks[s]),
                                             torch.tensor([s, s + 3], dtype=torch.int32))
        out[impl] = lg.numpy()
    assert _rel_err(out["kernel"], out["ref"]) <= 1e-5


def test_param_count_matches_jax():
    jcfg = jax_smoke("gemma3-4b")
    cfg = get_smoke_config("gemma3-4b")
    assert cfg.param_count() == jcfg.param_count()
    full = get_config("gemma3-4b")
    assert full.param_count() == 3_879_925_248
    assert jax_get_config("gemma3-4b").num_layers == full.num_layers


def test_other_families_name_their_slice():
    # every family is ported (tests/test_torch_moe.py, tests/test_torch_prefill.py,
    # tests/test_torch_rwkv6.py, tests/test_torch_hymba.py, tests/test_torch_whisper.py);
    # a family the registry does not know raises
    for arch in ("deepseek-moe-16b", "internvl2-76b", "rwkv6-3b", "hymba-1.5b",
                 "whisper-tiny"):
        assert registry.param_count(get_smoke_config(arch)) > 0
    with pytest.raises(KeyError, match="unknown family"):
        registry.family_module(get_smoke_config("gemma3-4b").replace(family="retnet"))
