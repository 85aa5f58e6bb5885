"""RWKV6 wkv scan: the port's plain version held to the JAX package, the
JAX package's two faults on this path pinned, and the wrapper's CPU routing
and checks.  The CUDA kernel's own tests, which need no jax, are in
test_torch_rwkv6_scan_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6_scan
from repro.kernels.rwkv6_scan import rwkv6_scan_ref as jax_scan_oracle
from repro.models import rwkv6 as jrwkv6
from repro_torch.kernels.rwkv6_scan import ops, rwkv6_scan_ref, rwkv6_scan_step_ref
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_segmented_ref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py holds the Pallas kernel at (atol 2e-4, rtol 2e-3), hard decay at
# (1e-4, 1e-3); both versions compute in fp32 from the same inputs, and the data allow 10x
# tighter (the largest difference over the sweep is 1.2e-5 at |y| <= 36)
TOL = dict(atol=2e-5, rtol=2e-4)
HARD_TOL = dict(atol=1e-5, rtol=1e-4)


def _inputs(B, T, H, D, seed=0, hard=False):
    """Scaled as in tests/test_kernels.py::test_rwkv6_scan_sweep; hard: logw at
    the clip floor -8, k unscaled, u = 0, as in test_rwkv6_hard_decay_stability."""
    g = np.random.default_rng(seed)
    r = g.standard_normal((B, T, H, D))
    k = g.standard_normal((B, T, H, D)) * (1.0 if hard else 0.3)
    v = g.standard_normal((B, T, H, D))
    lw = (np.full((B, T, H, D), -8.0) if hard
          else -np.clip(np.exp(g.standard_normal((B, T, H, D)) * 0.5 - 1.0), 1e-4, 8.0))
    u = np.zeros((H, D)) if hard else g.standard_normal((H, D)) * 0.2
    return [a.astype(np.float32) for a in (r, k, v, lw, u)]


def _torch(arrs, dtype="float32"):
    """r, k, v in ``dtype`` (the same bf16 rounding as jnp's), logw and u float32."""
    r, k, v, lw, u = (torch.from_numpy(a) for a in arrs)
    dt = DTYPES[dtype][1]
    return r.to(dt), k.to(dt), v.to(dt), lw, u


def _jax(arrs, dtype="float32"):
    r, k, v, lw, u = (jnp.asarray(a) for a in arrs)
    dt = DTYPES[dtype][0]
    return r.astype(dt), k.astype(dt), v.astype(dt), lw, u


def _oracle(arrs, s0=None):
    """JAX's per-token oracle, on the (BH, T, D) layout it takes -> model layout."""
    r, k, v, lw, u = arrs
    b, t, h, d = r.shape

    def fold(a):
        return a.transpose(0, 2, 1, 3).reshape(b * h, t, d)
    s0 = np.zeros((b, h, d, d), np.float32) if s0 is None else s0
    y, s = jax_scan_oracle(fold(r), fold(k), fold(v), fold(lw),
                           np.tile(u[None], (b, 1, 1)).reshape(b * h, d),
                           s0.reshape(b * h, d, d))
    return (np.asarray(y).reshape(b, h, t, d).transpose(0, 2, 1, 3),
            np.asarray(s).reshape(b, h, d, d))


def _close(out, ref, **tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref, np.float32), **tol)


# the sweep of tests/test_kernels.py::test_rwkv6_scan_sweep (chunk 16)
SWEEP = [(2, 64, 4, 64), (1, 48, 2, 32), (2, 80, 3, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,D", SWEEP)
def test_plain_matches_jax_sweep(B, T, H, D, dtype):
    arrs = _inputs(B, T, H, D)
    y, s = rwkv6_scan_ref(*_torch(arrs, dtype))
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (B, T, H, D) and s.shape == (B, H, D, D)
    for kw in (dict(interpret=True), dict(impl="ref")):
        jy, js = jax_rwkv6_scan(*_jax(arrs, dtype), **kw)
        _close(y, jy, **TOL)
        _close(s, js, **TOL)


def test_plain_matches_jax_hard_decay():
    arrs = _inputs(1, 64, 2, 32, hard=True)
    y, s = rwkv6_scan_ref(*_torch(arrs))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    for kw in (dict(interpret=True), dict(impl="ref")):
        jy, js = jax_rwkv6_scan(*_jax(arrs), **kw)
        _close(y, jy, **HARD_TOL)
        _close(s, js, **HARD_TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,T,H,D", [(2, 37, 3, 64), (1, 1, 2, 32), (2, 100, 2, 16),
                                     (1, 16, 4, 32)])
def test_plain_equals_the_per_token_oracle_at_any_T(B, T, H, D, with_state):
    """Any T, the tail of the last chunk included, from a zero or a non-zero state."""
    arrs = _inputs(B, T, H, D, seed=T)
    s0 = (np.random.default_rng(1).standard_normal((B, H, D, D)).astype(np.float32)
          if with_state else None)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    y, s = rwkv6_scan_ref(*_torch(arrs), ts0)
    jy, js = _oracle(arrs, s0)
    _close(y, jy, **TOL)
    _close(s, js, **TOL)
    sy, ss = rwkv6_scan_step_ref(*_torch(arrs), ts0)
    _close(sy, jy, **TOL)
    _close(ss, js, **TOL)


def test_jax_padding_decays_the_state():
    """Fault 1 (ROADMAP Queue 3): at T % 16 != 0 both JAX fast paths pad logw
    with -1e-4, so their S is the oracle's times exp(-1e-4 * pad); y agrees."""
    B, T, H, D = 2, 37, 3, 32
    pad = (-T) % 16
    arrs = _inputs(B, T, H, D, seed=7)
    oy, os_ = _oracle(arrs)
    ours_y, ours_s = rwkv6_scan_ref(*_torch(arrs))
    _close(ours_s, os_, **TOL)
    decay = np.exp(np.float32(-1e-4) * pad)
    jy, js = jax_rwkv6_scan(*_jax(arrs), interpret=True)
    _close(jy, oy, **TOL)
    _close(js, os_ * decay, **TOL)
    assert np.abs(np.asarray(js) - os_).max() > 10 * TOL["atol"]
    cy, cs = jrwkv6.wkv_chunked(*_jax(arrs), jnp.zeros((B, H, D, D)))
    _close(cy, oy, **TOL)
    _close(cs, os_ * decay, **TOL)


def test_jax_pallas_branch_drops_the_input_state():
    """Fault 2 (ROADMAP Queue 3): JAX's time_mix passes no state to the Pallas
    kernel, so a non-zero state changes nothing there; its ref branch carries it."""
    cfg = jax_smoke("rwkv6-3b").replace(param_dtype="float32", compute_dtype="float32",
                                        remat="none")
    p = jax.jit(lambda key: jrwkv6.layer_init(cfg, key, "dense"))(jax.random.PRNGKey(0))["tm"]
    g = np.random.default_rng(2)
    h, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    x = jnp.asarray(g.standard_normal((2, 16, cfg.d_model)).astype(np.float32))
    state = jnp.asarray(g.standard_normal((2, h, dh, dh)).astype(np.float32))
    zero = jnp.zeros_like(state)
    outs = {}
    for impl in ("pallas_interpret", "ref"):
        c = cfg.replace(attn_impl=impl)
        outs[impl] = [jrwkv6.time_mix(c, p, x, jrwkv6._tshift(x), s) for s in (state, zero)]
    (pk_s, pk_ss), (pk_z, _) = outs["pallas_interpret"]
    (rf_s, rf_ss), (rf_z, _) = outs["ref"]
    _close(pk_s, pk_z, atol=0, rtol=0)
    _close(pk_z, rf_z, **TOL)
    assert np.abs(np.asarray(rf_s) - np.asarray(rf_z)).max() > 1e-2
    assert np.abs(np.asarray(pk_ss) - np.asarray(rf_ss)).max() > 1e-2


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    before = ops.launches
    args = _torch(_inputs(2, 20, 2, 32, seed=3), "bfloat16")
    s0 = torch.randn((2, 2, 32, 32), generator=torch.Generator().manual_seed(0))
    y, s = ops.rwkv6_scan(*args, s0)
    assert ops.launches == before
    ey, es = rwkv6_scan_ref(*args, s0)
    assert torch.equal(y, ey) and torch.equal(s, es)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    r, k, v, lw, u = _torch(_inputs(1, 16, 2, 32))
    with pytest.raises(ValueError, match="r must be"):
        ops.rwkv6_scan(r[0], k, v, lw, u)
    with pytest.raises(ValueError, match="share one shape"):
        ops.rwkv6_scan(r, k[:, :8], v, lw, u)
    with pytest.raises(ValueError, match="u must be"):
        ops.rwkv6_scan(r, k, v, lw, u[0])
    with pytest.raises(ValueError, match="s0 must be"):
        ops.rwkv6_scan(r, k, v, lw, u, torch.zeros((1, 2, 32, 16)))
    with pytest.raises(ValueError, match="head dim 24"):
        ops.rwkv6_scan(*(x[..., :24] for x in (r, k, v, lw)), u[:, :24])
    with pytest.raises(TypeError, match="share one of"):
        ops.rwkv6_scan(r.half(), k.half(), v.half(), lw, u)
    with pytest.raises(TypeError, match="share one of"):
        ops.rwkv6_scan(r, k.bfloat16(), v, lw, u)
    with pytest.raises(TypeError, match="logw must be float32"):
        ops.rwkv6_scan(r, k, v, lw.bfloat16(), u)
    with pytest.raises(TypeError, match="s0 must be float32"):
        ops.rwkv6_scan(r, k, v, lw, u, torch.zeros((1, 2, 32, 32), dtype=torch.float64))
    with pytest.raises(ValueError, match="one device"):
        ops.rwkv6_scan(r, k, v, lw, u.to("meta"))


# the kernel's segments: a short segment here, so that T reaches several of them cheaply
SEG = 32


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [1, 15, 37, SEG - 1, SEG, SEG + 1, 3 * SEG + 5])
def test_segmented_ref_matches_plain_oracle_and_jax(T, with_state):
    """The segment decomposition against the chunked plain version, the per-token
    recurrence and JAX's oracle (y and S, from s0), and the Pallas kernel (interpret
    mode: y, and S where no pad decays it and the state is zero)."""
    B, H, D = 2, 3, 32
    arrs = _inputs(B, T, H, D, seed=100 + T)
    s0 = (np.random.default_rng(T).standard_normal((B, H, D, D)).astype(np.float32)
          if with_state else None)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    y, s = rwkv6_scan_segmented_ref(*_torch(arrs), ts0, seg=SEG)
    assert y.shape == (B, T, H, D) and s.shape == (B, H, D, D)
    for ry, rs in (rwkv6_scan_ref(*_torch(arrs), ts0), rwkv6_scan_step_ref(*_torch(arrs), ts0),
                   _oracle(arrs, s0)):
        _close(y, ry, **TOL)
        _close(s, rs, **TOL)
    if not with_state:
        jy, js = jax_rwkv6_scan(*_jax(arrs), interpret=True)
        _close(y, jy, **TOL)
        if T % 16 == 0:
            _close(s, js, **TOL)


def test_segmented_ref_at_the_hard_decay():
    """logw = -8 everywhere: each segment's decay underflows to 0, the right limit."""
    arrs = _inputs(1, 3 * SEG + 5, 2, 32, hard=True)
    s0 = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 2, 32, 32))
                          .astype(np.float32))
    y, s = rwkv6_scan_segmented_ref(*_torch(arrs), s0, seg=SEG)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    for ry, rs in (rwkv6_scan_ref(*_torch(arrs), s0), _oracle(arrs, s0.numpy())):
        _close(y, ry, **HARD_TOL)
        _close(s, rs, **HARD_TOL)
    jy, _ = jax_rwkv6_scan(*_jax(arrs), interpret=True)
    _close(rwkv6_scan_segmented_ref(*_torch(arrs), seg=SEG)[0], jy, **HARD_TOL)


def test_segmented_ref_rejects_a_segment_no_chunk_divides():
    with pytest.raises(ValueError, match="multiple of 16"):
        rwkv6_scan_segmented_ref(*_torch(_inputs(1, 20, 1, 16)), seg=24)
