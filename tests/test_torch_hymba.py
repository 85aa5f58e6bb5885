"""The port's hybrid family (hymba) held to the JAX package on the CPU: the
Mamba branch's pieces, forward, prefill with its caches, one-token decode
from a zero cache (the served path) and after a prefill, init, and the
full-width parameter count.

Weights are made once by the JAX init and carried to the port through numpy
(``convert.params_from_jax``), so both packages compute on the same numbers.
On CPU tensors ``attn_impl="kernel"`` runs the attention kernels' plain
versions; JAX runs ``attn_impl="ref"``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import hymba as jhymba
from repro.models import registry as jregistry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import convert, hymba, registry, stack

ARCH = "hymba-1.5b"
F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
IMPLS = ["ref", "kernel"]
TOL = dict(rtol=1e-5, atol=1e-5)


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


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_cache_layers(cfg, jcache):
    """JAX's run-stacked cache -> the port's per-layer list of numpy dicts."""
    flat = convert.params_from_jax(cfg, jax.tree.map(np.asarray, {"head": {}, "runs": jcache}))
    return [{k: v.numpy() for k, v in layer.items()} for layer in flat["layers"]]


def _assert_cache_close(cache, jcache_layers):
    assert len(cache) == len(jcache_layers)
    for ours, theirs in zip(cache, jcache_layers):
        assert set(ours) == set(theirs) == {"k", "v", "ssm_h", "conv"}
        for k in ours:
            assert ours[k].shape == theirs[k].shape, k
            np.testing.assert_allclose(ours[k].numpy(), theirs[k], err_msg=k, **TOL)


def _mamba_params(layer=1):
    jparams, params = _params()
    # layer 1 sits in the second run (count 2): its JAX leaves carry the run axis
    jm = jax.tree.map(lambda a: jnp.asarray(a[0]), jparams["runs"][1][0]["mamba"])
    return jm, params["layers"][layer]["mamba"]


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_matches_jax(with_state):
    x, w, b = _normal((2, 7, 12), 0), _normal((4, 12), 1), _normal((12,), 2)
    state = _normal((2, 3, 12), 3) if with_state else None
    jout, jst = jhymba._conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if state is None else jnp.asarray(state))
    out, st = hymba._conv1d(_t(x), _t(w), _t(b), None if state is None else _t(state))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(st.numpy(), x[:, -3:])


@pytest.mark.parametrize("seq", [1, 9, 300])
def test_selective_scan_from_a_nonzero_state_matches_jax(seq):
    """From h0 != 0, at one token, a few, and more than one SCAN_BLOCK."""
    b, di, n = 2, 12, 5
    dt = np.log1p(np.exp(_normal((b, seq, di), 0) - 2.0)).astype(np.float32)
    a = -np.exp(_normal((di, n), 1) * 0.5).astype(np.float32)
    bb, cc, x = _normal((b, seq, n), 2), _normal((b, seq, n), 3), _normal((b, seq, di), 4)
    d_skip, h0 = _normal((di,), 5), _normal((b, di, n), 6)
    jy, jh = jhymba.selective_scan(*(jnp.asarray(v) for v in (dt, a, bb, cc, x, d_skip, h0)))
    h0_t = _t(h0)
    y, h = hymba.selective_scan(*(_t(v) for v in (dt, a, bb, cc, x, d_skip)), h0_t)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_array_equal(h0_t.numpy(), h0)          # the input state is not written


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply_matches_jax(with_state):
    jcfg, cfg = _cfgs()
    jm, m = _mamba_params()
    di, _, n, k = hymba._dims(cfg)
    x = _normal((2, 11, cfg.d_model), 7)
    h0 = _normal((2, di, n), 8) if with_state else None
    cs = _normal((2, k - 1, di), 9) if with_state else None
    jy, (jh, jc) = jhymba.mamba_apply(jcfg, jm, jnp.asarray(x),
                                      None if h0 is None else jnp.asarray(h0),
                                      None if cs is None else jnp.asarray(cs))
    y, (h, c) = hymba.mamba_apply(cfg, m, _t(x), None if h0 is None else _t(h0),
                                  None if cs is None else _t(cs))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)


def test_full_width_param_count():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.num_meta_tokens) == (32, 1600, 25, 5, 64, 128)
    assert registry.param_count(cfg) == 1_662_468_800
    assert hymba._dims(cfg) == (3200, 100, 16, 4)


def test_init_matches_jax_shapes_dtypes_and_constants():
    _, cfg = _cfgs()
    _, ours = _params()
    mine = hymba.init_params(cfg.replace(param_dtype="bfloat16"), device="cpu", seed=3)

    def shapes(tree, path=""):
        if isinstance(tree, torch.Tensor):
            return {path: tuple(tree.shape)}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items for k, v in shapes(sub, f"{path}/{key}").items()}
    assert shapes(mine) == shapes(ours)
    assert mine["meta"].shape == (cfg.num_meta_tokens, cfg.d_model)
    assert all(t.dtype == torch.bfloat16 for t in registry.leaves(mine))
    m, jm = mine["layers"][0]["mamba"], ours["layers"][0]["mamba"]
    assert torch.equal(m["A_log"], jm["A_log"].bfloat16())     # log(1..N), fp32 then cast
    assert (m["dt_bias"] == torch.tensor(-4.6).bfloat16()).all()
    assert (m["D"] == 1).all() and (m["conv_b"] == 0).all()
    assert 0.07 < m["conv_w"].float().std().item() < 0.13      # normal * 0.1
    assert 0.015 < mine["meta"].float().std().item() < 0.025   # normal * 0.02


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(impl):
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    toks = _tokens(2, 24)
    jlg, _ = jax.jit(functools.partial(jregistry.forward, jcfg))(jparams,
                                                                 {"tokens": jnp.asarray(toks)})
    lg, aux = registry.forward(cfg.replace(attn_impl=impl), params, {"tokens": _t(toks)})
    assert lg.shape == (2, 24, cfg.vocab_size) and aux == {}
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_then_decode_match_jax_cache_included(impl):
    """Prefill of 20 tokens (28 with the meta tokens, past the smoke window of
    16) with every cache entry, then 4 decode steps."""
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    toks = _tokens(2, 24, seed=2)
    jlg, jc = jax.jit(functools.partial(jregistry.prefill, jcfg))(
        jparams, jregistry.init_cache(jcfg, 2, 32), {"tokens": jnp.asarray(toks[:, :20])})
    cfg = cfg.replace(attn_impl=impl)
    cache = registry.init_cache(cfg, 2, 32, device="cpu")
    lg, c = registry.prefill(cfg, params, cache, {"tokens": _t(toks[:, :20])})
    assert c is cache and lg.shape == (2, 20, cfg.vocab_size)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_cache_close(cache, _jax_cache_layers(cfg, jc))
    jstep = jax.jit(functools.partial(jregistry.decode_step, jcfg))
    for i in range(20, 24):
        pos = np.full((2,), i, np.int32)
        jlg, jc = jstep(jparams, jc, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos))
        lg, _ = registry.decode_step(cfg, params, cache, _t(toks[:, i:i + 1]), _t(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_cache_close(cache, _jax_cache_layers(cfg, jc))


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_from_a_zero_cache_matches_jax(impl):
    """The served path: token by token from a zero cache, at pos + M, with the
    meta tokens' keys at cache positions [0, M) left zero and attended (no
    prefill writes them), as the JAX replica does (ROADMAP Queue 3); the rows
    at different positions.  So its logits are not forward's."""
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    toks = _tokens(2, 20, seed=3)
    jc = jregistry.init_cache(jcfg, 2, 24)
    cfg = cfg.replace(attn_impl=impl)
    cache = registry.init_cache(cfg, 2, 24, device="cpu")
    jstep = jax.jit(functools.partial(jregistry.decode_step, jcfg))
    ours = []
    for i in range(20):
        pos = np.array([i, i + 3] if i + 3 < 24 else [i, i], np.int32)
        jlg, jc = jstep(jparams, jc, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos))
        lg, _ = registry.decode_step(cfg, params, cache, _t(toks[:, i:i + 1]), _t(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        ours.append(lg[:, 0])
    _assert_cache_close(cache, _jax_cache_layers(cfg, jc))
    m = cfg.num_meta_tokens
    for window, layer in zip(stack.layer_windows(cfg), cache):
        if window is None:                             # a full cache: [0, M) never written
            assert (layer["k"][:, :m] == 0).all() and (layer["v"][:, :m] == 0).all()
    full, _ = registry.forward(cfg, params, {"tokens": _t(toks)})
    assert (torch.stack(ours, 1)[0] - full[0]).abs().max() > 1e-3


def test_kernel_path_on_cpu_equals_ref_path():
    _, cfg = _cfgs()
    _, params = _params()
    toks = _t(_tokens(2, 37))
    lk, _ = registry.forward(cfg.replace(attn_impl="kernel"), params, {"tokens": toks})
    lr, _ = registry.forward(cfg.replace(attn_impl="ref"), params, {"tokens": toks})
    np.testing.assert_allclose(lk.numpy(), lr.numpy(), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_ignores_the_cache_state_as_jax_does(impl):
    """A cache holding Mamba state: prefill starts the branch from zero all the
    same (JAX's ``layer_prefill`` passes no state; ROADMAP Queue 3)."""
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    g = np.random.default_rng(4)
    jcache = jax.tree.map(lambda a: np.asarray(g.standard_normal(a.shape) * 0.5, a.dtype),
                          jregistry.init_cache(jcfg, 2, 16))
    toks = _tokens(2, 12, seed=5)
    jlg, jc = jregistry.prefill(jcfg, jparams, jax.tree.map(jnp.asarray, jcache),
                                {"tokens": jnp.asarray(toks)})
    cfg = cfg.replace(attn_impl=impl)
    cache = [{k: _t(v) for k, v in layer.items()} for layer in _jax_cache_layers(cfg, jcache)]
    lg, _ = registry.prefill(cfg, params, cache, {"tokens": _t(toks)})
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_cache_close(cache, _jax_cache_layers(cfg, jc))
    zero = registry.init_cache(cfg, 2, 16, device="cpu")
    lz, _ = registry.prefill(cfg, params, zero, {"tokens": _t(toks)})
    np.testing.assert_allclose(lz.numpy(), lg.numpy(), **TOL)


def test_prefill_then_decode_equals_forward():
    """Prefill of 13 tokens, then 5 decode steps: the logits are forward's over
    the 18 tokens (caches and Mamba state carried across)."""
    _, cfg = _cfgs(attn_impl="kernel")
    _, params = _params()
    toks = _t(_tokens(2, 18, seed=6))
    cache = registry.init_cache(cfg, 2, 18, device="cpu")
    lg, _ = registry.prefill(cfg, params, cache, {"tokens": toks[:, :13]})
    steps = [registry.decode_step(cfg, params, cache, toks[:, i:i + 1],
                                  torch.full((2,), i, dtype=torch.int32))[0][:, 0]
             for i in range(13, 18)]
    full, _ = registry.forward(cfg, params, {"tokens": toks})
    np.testing.assert_allclose(lg.numpy(), full[:, :13].numpy(), **TOL)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full[:, 13:].numpy(), **TOL)


def test_reset_slot_zeroes_the_mamba_state_only():
    _, cfg = _cfgs()
    cache = registry.init_cache(cfg, 3, 8, device="cpu")
    for layer in cache:
        for t in layer.values():
            t.fill_(1.0)
    registry.reset_slot(cfg, cache, 1)
    for layer in cache:
        for name, t in layer.items():
            assert (t[0] == 1).all() and (t[2] == 1).all()
            assert (t[1] == 0).all() if name in ("ssm_h", "conv") else (t[1] == 1).all()


def test_cache_shapes_match_jax():
    jcfg, cfg = _cfgs()
    for b, s in ((2, 24), (1, 5)):
        theirs = _jax_cache_layers(cfg, jregistry.init_cache(jcfg, b, s))
        ours = registry.init_cache(cfg, b, s, device="cpu")
        assert [{k: (tuple(v.shape), str(v.dtype).split(".")[1]) for k, v in x.items()}
                for x in ours] == [{k: (v.shape, v.dtype.name) for k, v in x.items()}
                                   for x in theirs]


def test_reset_slot_leaves_ring_slots_of_the_meta_positions_as_jax_does():
    """A ring layer maps the meta positions [0, M) to slots [0, M), which a
    request that decodes past W - M tokens overwrites.  After reset_slot (the
    Mamba state zeroed, the attention caches left) a new request in that slot
    attends those entries where a fresh cache holds zeros; the JAX package,
    its state zeroed the same way, computes the same (ROADMAP Queue 3)."""
    jcfg, cfg = _cfgs(attn_impl="kernel")
    jparams, params = _params()
    toks = _tokens(2, 24, seed=7)
    jstep = jax.jit(functools.partial(jregistry.decode_step, jcfg))
    jc = jregistry.init_cache(jcfg, 2, 24)
    cache = registry.init_cache(cfg, 2, 24, device="cpu")
    for i in range(12):                 # p = 8..19: the ring of 16 wraps onto slots 0..3
        pos = np.full((2,), i, np.int32)
        jlg, jc = jstep(jparams, jc, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos))
        registry.decode_step(cfg, params, cache, _t(toks[:, i:i + 1]), _t(pos))
    registry.reset_slot(cfg, cache, 0)
    runs = stack.compute_runs(cfg)
    jc = [[{k: (v.at[(slice(None),) * (run.count > 1) + (0,)].set(0)
                if k in ("ssm_h", "conv") else v) for k, v in sub.items()} for sub in subs]
          for run, subs in zip(runs, jc)]
    _assert_cache_close(cache, _jax_cache_layers(cfg, jc))
    fresh = registry.init_cache(cfg, 2, 24, device="cpu")
    for i in range(3):                  # row 0 starts over at pos 0; row 1 goes on
        pos = np.array([i, 12 + i], np.int32)
        tok = toks[:, 12 + i:13 + i]
        jlg, jc = jstep(jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        lg, _ = registry.decode_step(cfg, params, cache, _t(tok), _t(pos))
        lf, _ = registry.decode_step(cfg, params, fresh, _t(tok), _t(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    assert (lg[0] - lf[0]).abs().max() > 1e-3
