"""Decode attention: the port's plain version held to the JAX package, and
the wrapper's CPU routing and checks.  The CUDA kernel's own tests, which
need no jax, are in test_torch_decode_attention_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro_torch.kernels.decode_attention import decode_attention_ref, ops
from repro_torch.kernels.decode_attention.ref import (decode_attention_f64_ref,
                                                       decode_attention_split_ref, split_ranges)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    # the _tol of tests/test_kernels.py
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(B, T, H, K, D, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, 1, H, D)).astype(np.float32)
    k = r.standard_normal((B, T, K, D)).astype(np.float32)
    v = r.standard_normal((B, T, K, D)).astype(np.float32)
    pos = r.integers(1, T, B).astype(np.int32)
    return q, k, v, pos


def _torch(arrs, dtype, device="cpu"):
    q, k, v, pos = arrs
    cast = [torch.from_numpy(a).to(device=device, dtype=DTYPES[dtype][1]) for a in (q, k, v)]
    return (*cast, torch.from_numpy(pos).to(device))


# the sweep of tests/test_kernels.py::test_decode_attention_sweep, plus the
# gemma3-4b global-layer shape (H=8, K=4, D=256)
SWEEP = [
    (2, 256, 4, 2, 64, None),
    (1, 512, 8, 1, 128, None),
    (3, 128, 6, 6, 64, 50.0),
    (2, 256, 8, 4, 256, None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,K,D,softcap", SWEEP)
def test_plain_matches_jax(B, T, H, K, D, softcap, dtype):
    arrs = _inputs(B, T, H, K, D)
    jd = DTYPES[dtype][0]
    jq, jk, jv = (jnp.asarray(a, jd) for a in arrs[:3])
    jpos = jnp.asarray(arrs[3])
    out = decode_attention_ref(*_torch(arrs, dtype), softcap=softcap).float().numpy()
    for kw in (dict(block_k=64, interpret=True), dict(impl="ref")):
        ref = jax_decode_attention(jq, jk, jv, jpos, softcap=softcap, **kw)
        np.testing.assert_allclose(out, np.asarray(ref, np.float32),
                                   atol=_tol(dtype), rtol=_tol(dtype))


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    before = ops.launches
    args = _torch(_inputs(2, 64, 4, 2, 32), "bfloat16")
    out = ops.decode_attention(*args, softcap=30.0)
    ref = decode_attention_ref(*args, softcap=30.0)
    assert ops.launches == before
    assert out.dtype == torch.bfloat16 and out.shape == (2, 1, 4, 32)
    assert torch.equal(out, ref)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, pos = _torch(_inputs(2, 64, 4, 2, 64), "float32")
    with pytest.raises(ValueError, match="q must be"):
        ops.decode_attention(q[:, 0], k, v, pos)
    with pytest.raises(ValueError, match="k, v must"):
        ops.decode_attention(q, k[:, :, :1], v, pos)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q[..., :48].contiguous(), k[..., :48], v[..., :48], pos)
    with pytest.raises(ValueError, match="multiple of K"):
        ops.decode_attention(q[:, :, :3].contiguous(), k, v, pos)
    with pytest.raises(TypeError, match="share one of"):
        ops.decode_attention(q.half(), k.half(), v.half(), pos)
    with pytest.raises(TypeError, match="share one of"):
        ops.decode_attention(q, k.bfloat16(), v, pos)
    with pytest.raises(TypeError, match="pos must be int32"):
        ops.decode_attention(q, k, v, pos.long())
    with pytest.raises(ValueError, match="softcap"):
        ops.decode_attention(q, k, v, pos, softcap=0.0)


# the kernel's split over the live keys: pos at 0, a tile's last key, the next tile's first,
# a random position and T - 1, one row each
def _split_case(T, H, K, D, seed=1, tile=16):
    q, k, v, _ = _inputs(5, T, H, K, D, seed=seed)
    pos = np.array([0, tile - 1, tile, np.random.default_rng(seed).integers(1, T - 1), T - 1],
                   np.int32)
    return q, k, v, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_split,softcap", [(1, None), (3, 50.0), (16, None)])
def test_split_ref_matches_plain_and_jax(n_split, softcap, dtype):
    arrs = _split_case(256, 4, 2, 64)
    tq = _torch(arrs, dtype)
    out = decode_attention_split_ref(*tq, n_split, 16, softcap=softcap)
    assert out.dtype == tq[0].dtype and out.shape == tq[0].shape
    np.testing.assert_allclose(out.float().numpy(),
                               decode_attention_ref(*tq, softcap=softcap).float().numpy(),
                               atol=_tol(dtype), rtol=_tol(dtype))
    jd = DTYPES[dtype][0]
    jq, jk, jv = (jnp.asarray(a, jd) for a in arrs[:3])
    for kw in (dict(block_k=64, interpret=True), dict(impl="ref")):
        ref = jax_decode_attention(jq, jk, jv, jnp.asarray(arrs[3]), softcap=softcap, **kw)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("T,n_split,tile", [(256, 1, 16), (256, 5, 16), (2048, 16, 16),
                                            (100, 7, 16), (48, 3, 16), (300, 4, 32)])
def test_split_ranges_cover_each_live_key_once(T, n_split, tile):
    """Every key <= pos in exactly one split, none past pos; runs start on a tile; the
    live splits come first."""
    pos = torch.tensor([0, tile - 1, tile, tile + 1, T // 2, T - 2, T - 1, T + 5],
                       dtype=torch.int32)
    for p, ranges in zip(pos.tolist(), split_ranges(pos, T, n_split, tile)):
        assert len(ranges) == n_split
        live = min(p + 1, T)
        seen = np.zeros(T, np.int64)
        for begin, end in ranges:
            seen[begin:end] += 1
            assert begin % tile == 0 or begin == end
        assert (seen[:live] == 1).all() and not seen[live:].any()
        sizes = [end - begin for begin, end in ranges]
        n_live = sum(s > 0 for s in sizes)
        assert all(s > 0 for s in sizes[:n_live]) and not any(sizes[n_live:])


@pytest.mark.parametrize("B,T,H,K,D,softcap", SWEEP)
def test_f64_ref_is_the_exact_attention_a_bf16_call_rounds(B, T, H, K, D, softcap):
    """decode_attention_f64_ref, which the card holds bf16 K1 calls to at (1e-6, 2^-8), is
    the JAX attention in float64, and a bf16 output rounded once from fp32 (the plain
    version's) lies within that tolerance of it."""
    arrs = _inputs(B, T, H, K, D, seed=4)
    q, k, v, pos = _torch(arrs, "bfloat16")
    x = decode_attention_f64_ref(q, k, v, pos, softcap=softcap)
    assert x.dtype == torch.float64 and x.shape == q.shape
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    ref = jax_decode_attention(jq, jk, jv, jnp.asarray(arrs[3]), softcap=softcap, impl="ref")
    np.testing.assert_allclose(x.numpy(), np.asarray(ref, np.float64), atol=2e-5, rtol=2e-5)
    out = decode_attention_ref(q, k, v, pos, softcap=softcap)
    share = (out.double() - x).abs() / (1e-6 + 2.0 ** -8 * x.abs())
    assert share.max().item() <= 1.0

