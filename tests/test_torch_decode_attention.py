"""Decode attention: the port's plain version held to the JAX package, and
the wrapper's CPU routing and checks.  The CUDA kernel's own tests, which
need no jax, are in test_torch_decode_attention_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro_torch.kernels.decode_attention import decode_attention_ref, ops

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
