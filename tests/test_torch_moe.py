"""The port's moe family (routing, dispatch, experts, MLA, decode) held to the
JAX package on the CPU.

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
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import convert, mla, moe, registry, stack

F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
ARCHS = ["deepseek-moe-16b", "deepseek-v2-lite-16b"]


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


def _cfgs(arch="deepseek-moe-16b", **over):
    return jax_smoke(arch).replace(**F32, **over), get_smoke_config(arch).replace(**F32, **over)


@functools.lru_cache(maxsize=None)
def _moe_params(seed=0):
    jcfg, _ = _cfgs()
    return _jax_init(jmoe.moe_init, jcfg, seed)


def _tokens(b, s, d, seed):
    return _rng(seed).standard_normal((b, s, d)).astype(np.float32)


# -- routing -----------------------------------------------------------------------


def test_route_matches_jax():
    jcfg, cfg = _cfgs()
    jp = _moe_params()
    xg = _tokens(2, 16, cfg.d_model, 1)
    jprobs, jids, jaux = jmoe._route(jcfg, jp, jnp.asarray(xg))
    probs, ids, aux = moe._route(cfg, _tree(jp), _t(xg))
    assert ids.shape == (2, 16, cfg.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("g", [1, 2, 7, 64, 4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch, g):
    for over in ({}, {"capacity_factor": 0.5}, {"capacity_factor": 64.0}):
        jcfg, cfg = _cfgs(arch, **over)
        assert moe._capacity(cfg, g) == jmoe._capacity(jcfg, g)
    assert moe._capacity(get_config(arch), 2) == 8     # decode at 2 slots


# -- dispatch, ragged and the whole FFN, with and without dropped tokens ------------

# at capacity_factor 0.5 an expert takes 8 of its ~16 tokens (drops); at 64 all


@pytest.mark.parametrize("cf", [0.5, 64.0])
def test_dispatch_matches_jax(cf):
    jcfg, cfg = _cfgs(capacity_factor=cf)
    jp, p = _moe_params(), _tree(_moe_params())
    xg = _tokens(1, 64, cfg.d_model, 2)
    jprobs, jids, _ = jmoe._route(jcfg, jp, jnp.asarray(xg))
    ref = jmoe._moe_dispatch(jcfg, jp, jnp.asarray(xg), jprobs, jids)
    out = moe._moe_dispatch(cfg, p, _t(xg), _t(jprobs), _t(jids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cf", [0.5, 64.0])
def test_ragged_matches_jax(cf):
    """Without drops the port's ragged equals JAX's; with drops it equals
    dispatch (JAX's ragged can erase a kept token there: ROADMAP Queue 3)."""
    jcfg, cfg = _cfgs(capacity_factor=cf, moe_impl="ragged")
    jp, p = _moe_params(), _tree(_moe_params())
    xg = jnp.asarray(_tokens(1, 64, cfg.d_model, 3))
    jprobs, jids, _ = jmoe._route(jcfg, jp, xg)
    out = moe._moe_ragged(cfg, p, _t(xg), _t(jprobs), _t(jids).long())
    dispatch = jmoe._moe_dispatch(jcfg, jp, xg, jprobs, jids)
    jragged = jmoe._moe_ragged(jcfg, jp, xg, jprobs, jids)
    np.testing.assert_allclose(out.numpy(), np.asarray(dispatch), rtol=1e-5, atol=1e-5)
    if cf == 64.0:
        np.testing.assert_allclose(out.numpy(), np.asarray(jragged), rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(np.asarray(jragged) - np.asarray(dispatch)).max() > 1e-2


@pytest.mark.parametrize("impl", ["dispatch", "ragged"])
@pytest.mark.parametrize("cf", [0.5, 64.0])
def test_moe_ffn_matches_jax(cf, impl):
    jcfg, cfg = _cfgs(capacity_factor=cf, moe_impl=impl)
    jp, p = _moe_params(), _tree(_moe_params())
    x = _tokens(2, 32, cfg.d_model, 4)
    # JAX's ragged drops differently (see test_ragged_matches_jax)
    jref = jcfg.replace(moe_impl="dispatch") if cf < 1 else jcfg
    ref, jaux = jmoe.moe_ffn(jref, jp, jnp.asarray(x))
    for attn_impl in ("ref", "kernel"):
        out, aux = moe.moe_ffn(cfg.replace(attn_impl=attn_impl), p, _t(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


def test_expert_ffn_matches_jax_pallas_interpret():
    jcfg, cfg = _cfgs()
    jp, p = _moe_params(), _tree(_moe_params())
    xe = _rng(5).standard_normal((2, cfg.num_experts, 8, cfg.d_model)).astype(np.float32)
    ref = jmoe._expert_ffn(jcfg.replace(attn_impl="pallas_interpret"), jp, jnp.asarray(xe))
    out = moe._expert_ffn(cfg.replace(attn_impl="kernel"), p, _t(xe))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# -- MLA -----------------------------------------------------------------------------


def test_mla_decode_matches_jax():
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    jp = _jax_init(jmla.init, jcfg, 1)
    p = _tree(jp)
    r = _rng(6)
    t = 24
    ckv = r.standard_normal((2, t, cfg.kv_lora_rank)).astype(np.float32)
    krope = r.standard_normal((2, t, cfg.qk_rope_head_dim)).astype(np.float32)
    x = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([5, 21], np.int32)
    jout, jc = jmla.decode(jcfg, jp, {"ckv": jnp.asarray(ckv), "krope": jnp.asarray(krope)},
                           jnp.asarray(x), jnp.asarray(pos))
    cache = {"ckv": _t(ckv), "krope": _t(krope)}
    out, c = mla.decode(cfg, p, cache, _t(x), _t(pos))
    assert c is cache    # updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for k in ("ckv", "krope"):
        np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), rtol=1e-5, atol=1e-5)
    assert mla.cache_shape(cfg, 2, t) == {k: v.shape for k, v in
                                          jmla.cache_shape(jcfg, 2, t).items()}


# -- the whole decode step ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jax.jit(functools.partial(jregistry.decode_step, jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_over_40_steps(arch):
    """40 steps, B=2 at unequal positions; logits held to JAX's ref and Pallas
    (interpret) paths."""
    jcfg, cfg = _cfgs(arch)
    cfg = cfg.replace(attn_impl="kernel")
    jparams = _jax_init(jregistry.init_params, jcfg, 0)
    params = convert.params_from_jax(cfg, jparams)
    max_seq, steps = 48, 40
    pos0 = np.array([0, 7], np.int32)
    toks = _rng(7).integers(0, cfg.vocab_size, (steps, 2, 1)).astype(np.int32)

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


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_impl_on_cpu_equals_ref(arch):
    """attn_impl="kernel" on CPU tensors runs the plain versions: same logits."""
    cfg = get_smoke_config(arch).replace(**F32)
    params = registry.init_params(cfg, device="cpu", seed=3)
    toks = _rng(8).integers(0, cfg.vocab_size, (12, 2, 1)).astype(np.int32)
    out = {}
    for impl in ("ref", "kernel"):
        c = cfg.replace(attn_impl=impl)
        cache = registry.init_cache(c, 2, 32, device="cpu")
        for s in range(12):
            lg, cache = registry.decode_step(c, params, cache, _t(toks[s]),
                                             torch.tensor([s, s + 3], dtype=torch.int32))
        out[impl] = lg.numpy()
    assert _rel_err(out["kernel"], out["ref"]) <= 1e-5


@pytest.mark.parametrize("arch,full_count", [("deepseek-moe-16b", 16_377_694_208),
                                             ("deepseek-v2-lite-16b", 15_708_450_304)])
def test_param_count_matches_jax(arch, full_count):
    assert get_smoke_config(arch).param_count() == jax_smoke(arch).param_count()
    assert get_config(arch).param_count() == jax_get_config(arch).param_count() == full_count


def test_init_lays_experts_out_for_the_kernel():
    cfg = get_smoke_config("deepseek-moe-16b").replace(param_dtype="bfloat16")
    params = registry.init_params(cfg, device="cpu", seed=0)
    assert "mlp" in params["layers"][0] and "moe" not in params["layers"][0]
    p = params["layers"][1]["moe"]
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    assert p["router"].dtype == torch.float32 and p["router"].shape == (d, e)
    for name, shape in (("wi_gate", (e, d, f)), ("wi_up", (e, d, f)), ("wo", (e, f, d))):
        assert p[name].shape == shape and p[name].is_contiguous()
        assert p[name].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("num_layers,counts", [(3, [1, 2]), (5, [1, 4])])
def test_convert_carries_moe_trees(arch, num_layers, counts):
    jcfg, cfg = _cfgs(arch, num_layers=num_layers)
    assert [r.count for r in stack.compute_runs(cfg)] == counts
    jparams = _jax_init(jregistry.init_params, jcfg, 2)
    params = convert.params_from_jax(cfg, jparams)
    assert len(params["layers"]) == num_layers
    ours = registry.init_params(cfg, device="meta")
    assert (jax.tree.map(lambda t: (tuple(t.shape), t.dtype), params)
            == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), ours))
    last = jparams["runs"][1][0]["moe"]
    for i in range(counts[1]):
        got = params["layers"][1 + i]["moe"]
        assert got["router"].dtype == torch.float32
        for name in ("router", "wi_gate", "wo"):
            assert got[name].is_contiguous()
            np.testing.assert_array_equal(got[name].numpy(), last[name][i])
