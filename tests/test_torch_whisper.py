"""The port's encoder-decoder family (whisper) held to the JAX package on the
CPU: sinusoidal positions, the encoder, forward, the cross and self caches
through ``prefill_cross`` and ``prefill``, one-token decode against a filled
and an all-zero cross cache, init, and the full-width parameter count.

Weights are made once by the JAX init and carried to the port through numpy
(``convert.params_from_jax`` unstacks ``enc`` and ``dec``).  Whisper reaches
no kernel, so ``attn_impl`` changes nothing; both settings are run.
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
from repro.models import whisper as jwhisper
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import convert, layers, registry, whisper

ARCH = "whisper-tiny"
F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
IMPLS = ["ref", "kernel"]
TOL = dict(rtol=1e-5, atol=1e-5)
CACHE_KEYS = ("self_k", "self_v", "cross_k", "cross_v")


def _cfgs(**over):
    over = {**F32, **over}
    return jax_smoke(ARCH).replace(**over), get_smoke_config(ARCH).replace(**over)


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    jcfg, cfg = _cfgs()
    jparams = jax.tree.map(np.asarray, jax.jit(functools.partial(jregistry.init_params, jcfg))(
        jax.random.PRNGKey(seed)))
    return jparams, convert.params_from_jax(cfg, jparams)


def _batch(b, s, seed=1):
    _, cfg = _cfgs()
    g = np.random.default_rng(seed)
    return {"tokens": g.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "enc_embeds": g.standard_normal((b, cfg.encoder_seq, cfg.d_model))
            .astype(np.float32)}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_cache_layers(jcache):
    """JAX's dict of (L, B, T, H, D) stacks -> the port's per-layer list of dicts."""
    n = np.asarray(jcache["self_k"]).shape[0]
    return [{k: np.asarray(jcache[k])[i] for k in CACHE_KEYS} for i in range(n)]


def _assert_cache_close(cache, jcache):
    theirs = _jax_cache_layers(jcache)
    assert len(cache) == len(theirs)
    for ours, ref in zip(cache, theirs):
        assert set(ours) == set(CACHE_KEYS)
        for k in CACHE_KEYS:
            assert ours[k].shape == ref[k].shape, k
            np.testing.assert_allclose(ours[k].numpy(), ref[k], err_msg=k, **TOL)


def test_sinusoidal_pos_matches_jax():
    """Within 1e-6 plus one float32 ulp of the position: torch's and XLA's exp
    part by one ulp on 20 of whisper-tiny's 192 frequencies, which moves the
    argument pos * freq by up to an ulp of pos (1.22e-4 read at pos 1024-2047);
    sin and cos of one argument agree within 6e-8."""
    for seq, dim in ((1, 4), (37, 64), (1500, 384), (2048, 384)):
        err = np.abs(layers.sinusoidal_pos(seq, dim).numpy()
                     - np.asarray(jlayers.sinusoidal_pos(seq, dim)))
        ulp = np.spacing(np.arange(seq, dtype=np.float32))[:, None]
        assert (err <= 1e-6 + ulp).all(), err.max()


def test_full_width_param_count():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.num_encoder_layers, cfg.d_model, cfg.encoder_seq,
            cfg.vocab_size) == (4, 4, 384, 1500, 51_865)
    assert registry.param_count(cfg) == 56_355_840


def test_init_matches_jax_shapes_and_dtypes():
    _, cfg = _cfgs()
    _, ours = _params()
    mine = whisper.init_params(cfg.replace(param_dtype="bfloat16"), device="cpu", seed=3)

    def shapes(tree, path=""):
        if isinstance(tree, torch.Tensor):
            return {path: tuple(tree.shape)}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items for k, v in shapes(sub, f"{path}/{key}").items()}
    assert shapes(mine) == shapes(ours)
    assert len(mine["enc"]) == cfg.num_encoder_layers and len(mine["dec"]) == cfg.num_layers
    assert all(t.dtype == torch.bfloat16 for t in registry.leaves(mine))
    assert (mine["enc_norm"] == 0).all() and (mine["dec"][0]["lnx"] == 0).all()


def test_mlp_is_tanh_gelu_as_jax():
    jparams, params = _params()
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(np.float32) * 3
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), jparams["dec"]["mlp"])
    ref = jwhisper._mlp(jp, jnp.asarray(x), jnp.float32)
    out = whisper._mlp(params["dec"][0]["mlp"], _t(x), torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_encode_matches_jax():
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    emb = _batch(2, 4)["enc_embeds"]
    ref = jwhisper.encode(jcfg, jparams, jnp.asarray(emb))
    out = whisper.encode(cfg, params, _t(emb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(impl):
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    batch = _batch(2, 12)
    jlg, _ = jax.jit(functools.partial(jregistry.forward, jcfg))(
        jparams, jax.tree.map(jnp.asarray, batch))
    lg, aux = registry.forward(cfg.replace(attn_impl=impl), params,
                               {k: _t(v) for k, v in batch.items()})
    assert lg.shape == (2, 12, cfg.vocab_size) and aux == {}
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)


def test_prefill_cross_matches_jax():
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    emb = _batch(2, 4, seed=3)["enc_embeds"]
    jc = jwhisper.prefill_cross(jcfg, jparams, jregistry.init_cache(jcfg, 2, 8),
                                jnp.asarray(emb))
    cache = registry.init_cache(cfg, 2, 8, device="cpu")
    assert whisper.prefill_cross(cfg, params, cache, _t(emb)) is cache
    _assert_cache_close(cache, jc)
    assert all((c["self_k"] == 0).all() for c in cache)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_then_decode_match_jax_cache_included(impl):
    """Prefill of 10 tokens (the self caches zeroed past them, as JAX leaves
    them), then 4 decode steps against the filled cross cache."""
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    batch = _batch(2, 14, seed=4)
    prompt = {"tokens": batch["tokens"][:, :10], "enc_embeds": batch["enc_embeds"]}
    jlg, jc = jax.jit(functools.partial(jregistry.prefill, jcfg))(
        jparams, jregistry.init_cache(jcfg, 2, 16), jax.tree.map(jnp.asarray, prompt))
    cfg = cfg.replace(attn_impl=impl)
    cache = registry.init_cache(cfg, 2, 16, device="cpu")
    for layer in cache:                 # stale self entries past the prompt are cleared
        layer["self_k"].fill_(3.0)
    lg, c = registry.prefill(cfg, params, cache, {k: _t(v) for k, v in prompt.items()})
    assert c is cache and lg.shape == (2, 10, cfg.vocab_size)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_cache_close(cache, jc)
    jstep = jax.jit(functools.partial(jregistry.decode_step, jcfg))
    toks = batch["tokens"]
    for i in range(10, 14):
        pos = np.full((2,), i, np.int32)
        jlg, jc = jstep(jparams, jc, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos))
        lg, _ = registry.decode_step(cfg, params, cache, _t(toks[:, i:i + 1]), _t(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_cache_close(cache, jc)
    full, _ = registry.forward(cfg, params, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 13].numpy(), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_against_a_zero_cross_cache_matches_jax(impl):
    """The served path: token by token from a zero cache, the cross cache never
    filled (the JAX replica never calls prefill_cross; ROADMAP Queue 3), at
    different positions per row."""
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    toks = _batch(2, 12, seed=5)["tokens"]
    jc = jregistry.init_cache(jcfg, 2, 16)
    cfg = cfg.replace(attn_impl=impl)
    cache = registry.init_cache(cfg, 2, 16, device="cpu")
    jstep = jax.jit(functools.partial(jregistry.decode_step, jcfg))
    for i in range(12):
        pos = np.array([i, i + 4], np.int32)
        jlg, jc = jstep(jparams, jc, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos))
        lg, _ = registry.decode_step(cfg, params, cache, _t(toks[:, i:i + 1]), _t(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_cache_close(cache, jc)
    assert all((c["cross_k"] == 0).all() and (c["cross_v"] == 0).all() for c in cache)


def test_decode_against_a_filled_cross_cache_differs_from_a_zero_one():
    _, cfg = _cfgs()
    _, params = _params()
    batch = _batch(2, 1, seed=6)
    filled = whisper.prefill_cross(cfg, params, registry.init_cache(cfg, 2, 4, device="cpu"),
                                   _t(batch["enc_embeds"]))
    zero = registry.init_cache(cfg, 2, 4, device="cpu")
    pos = torch.zeros(2, dtype=torch.int32)
    lf, _ = registry.decode_step(cfg, params, filled, _t(batch["tokens"]), pos)
    lz, _ = registry.decode_step(cfg, params, zero, _t(batch["tokens"]), pos)
    assert (lf - lz).abs().max() > 1e-3


def test_cache_shapes_match_jax():
    jcfg, cfg = _cfgs()
    theirs = _jax_cache_layers(jregistry.init_cache(jcfg, 2, 24))
    ours = registry.init_cache(cfg, 2, 24, device="cpu")
    assert [{k: tuple(v.shape) for k, v in x.items()} for x in ours] == \
        [{k: v.shape for k, v in x.items()} for x in theirs]
    assert registry.reset_slot(cfg, ours, 0) is None      # no recurrent state to reset
