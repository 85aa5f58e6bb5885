"""Grouped expert FFN: the port's plain version held to the JAX package, and
the wrapper's CPU routing and checks.  The CUDA kernel's own tests, which
need no jax, are in test_torch_moe_gemm_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm import moe_expert_ffn as jax_moe_expert_ffn
from repro_torch.kernels.moe_gemm import moe_expert_ffn_ref, ops

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    # tests/test_kernels.py::test_moe_gemm_sweep holds the Pallas kernel at _tol * 4
    return 4 * (2e-2 if dtype == "bfloat16" else 2e-5)


def _inputs(E, C, d, f, seed=0):
    """Scaled as in tests/test_kernels.py: x * 0.5, weights / sqrt(fan-in)."""
    r = np.random.default_rng(seed)
    return ((r.standard_normal((E, C, d)) * 0.5).astype(np.float32),
            (r.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32),
            (r.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32),
            (r.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32))


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(DTYPES[dtype][1]) for a in arrs]


# the sweep of tests/test_kernels.py::test_moe_gemm_sweep, plus 16 experts at
# the decode capacity C = 8
SWEEP = [(4, 128, 256, 512), (8, 64, 128, 256), (2, 256, 128, 384), (16, 8, 256, 384)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", SWEEP)
def test_plain_matches_jax(E, C, d, f, dtype):
    arrs = _inputs(E, C, d, f)
    jargs = [jnp.asarray(a, DTYPES[dtype][0]) for a in arrs]
    out = moe_expert_ffn_ref(*_torch(arrs, dtype))
    assert out.dtype == DTYPES[dtype][1] and out.shape == (E, C, d)
    for kw in (dict(block_c=64, block_f=128, interpret=True), dict(impl="ref")):
        ref = jax_moe_expert_ffn(*jargs, **kw)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   atol=_tol(dtype), rtol=_tol(dtype))


def test_zero_rows_give_zero_rows():
    x, wg, wu, wo = _torch(_inputs(4, 16, 64, 96, seed=1), "float32")
    x[:, 5:11] = 0.0
    out = ops.moe_expert_ffn(x, wg, wu, wo)
    assert torch.count_nonzero(out[:, 5:11]) == 0
    assert torch.count_nonzero(out[:, :5]) > 0


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    before = ops.launches
    args = _torch(_inputs(4, 8, 64, 32, seed=2), "bfloat16")
    out = ops.moe_expert_ffn(*args)
    assert ops.launches == before
    assert out.dtype == torch.bfloat16 and out.shape == (4, 8, 64)
    assert torch.equal(out, moe_expert_ffn_ref(*args))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, wg, wu, wo = _torch(_inputs(4, 8, 64, 32), "float32")
    with pytest.raises(ValueError, match="x must be"):
        ops.moe_expert_ffn(x[0], wg, wu, wo)
    with pytest.raises(ValueError, match="wg, wu must"):
        ops.moe_expert_ffn(x, wg[:3], wu, wo)
    with pytest.raises(ValueError, match="wo must be"):
        ops.moe_expert_ffn(x, wg, wu, wo[:, :16])
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.moe_expert_ffn(x[..., :60].contiguous(), wg[:, :60].contiguous(),
                           wu[:, :60].contiguous(), wo[..., :60].contiguous())
    with pytest.raises(TypeError, match="share one of"):
        ops.moe_expert_ffn(x.half(), wg.half(), wu.half(), wo.half())
    with pytest.raises(TypeError, match="share one of"):
        ops.moe_expert_ffn(x, wg.bfloat16(), wu, wo)
    with pytest.raises(ValueError, match="x must be contiguous"):
        ops.moe_expert_ffn(x.transpose(0, 1).contiguous().transpose(0, 1), wg, wu, wo)
    with pytest.raises(ValueError, match="wo must be contiguous"):
        ops.moe_expert_ffn(x, wg, wu, wo.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="one device"):
        ops.moe_expert_ffn(x, wg.to("meta"), wu, wo)
