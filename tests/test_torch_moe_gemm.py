"""Grouped expert FFN: the port's plain version held to the JAX package, and
the wrapper's CPU routing and checks.  The CUDA kernel's own tests, which
need no jax, are in test_torch_moe_gemm_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm import moe_expert_ffn as jax_moe_expert_ffn
from repro.kernels.moe_gemm import moe_expert_ffn_ref as jax_moe_expert_ffn_ref
from repro_torch.kernels.moe_gemm import moe_expert_ffn_ref, ops
from repro_torch.kernels.moe_gemm.ref import moe_expert_ffn_bf16h_ref

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


@pytest.mark.parametrize("E,C,d,f", SWEEP + [(3, 24, 136, 200), (2, 3, 2056, 8)])
def test_bf16_h_rounding_fits_the_tolerance(E, C, d, f):
    """The bf16 designs' arithmetic (h rounded to bf16 between the passes, as the
    card tests hold them to it) against JAX's reference, which keeps h in fp32."""
    arrs = _inputs(E, C, d, f, seed=3)
    out = moe_expert_ffn_bf16h_ref(*_torch(arrs, "bfloat16")).float().numpy()
    ref = np.asarray(jax_moe_expert_ffn_ref(*[jnp.asarray(a, jnp.bfloat16) for a in arrs]),
                     np.float32)
    tol = _tol("bfloat16")
    err = np.abs(out - ref)
    # assert_allclose's test is err <= atol + rtol |ref|; the margin is how much of it is used
    margin = (err / (tol + tol * np.abs(ref))).max()
    print(f"E={E} C={C} d={d} f={f}: max |err| {err.max():.3g}, "
          f"worst err / tolerance {margin:.3f}")
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero", [0.0, -0.0])
def test_plain_gives_exact_zeros_for_empty_experts(zero, dtype):
    arrs = _inputs(6, 16, 128, 256, seed=4)
    arrs[0][[1, 4]] = zero                # two whole experts hold no token
    arrs[0][2, 1:] = 0.0                  # one holds a single token
    out = moe_expert_ffn_ref(*_torch(arrs, dtype))
    ref = jax_moe_expert_ffn(*[jnp.asarray(a, DTYPES[dtype][0]) for a in arrs], impl="ref")
    assert torch.count_nonzero(out[[1, 4]]) == 0
    assert torch.count_nonzero(out[2, 0]) > 0
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=_tol(dtype), rtol=_tol(dtype))


def test_route_by_type_and_capacity():
    assert ops.route(torch.float32, 1) == ops.route(torch.float32, 480) == "fma"
    assert ops.route(torch.bfloat16, 1) == ops.route(torch.bfloat16, 8) == "stream"
    assert ops.route(torch.bfloat16, ops.STREAM_MAX_C) == "stream"
    assert ops.route(torch.bfloat16, ops.STREAM_MAX_C + 1) == "wgmma"
    assert ops.route(torch.bfloat16, 480) == "wgmma"


@pytest.mark.parametrize("design,dtype,C", [("stream", "bfloat16", ops.STREAM_MAX_C + 1),
                                            ("stream", "float32", 8), ("wgmma", "float32", 8),
                                            ("fma", "bfloat16", 8), ("tf32", "float32", 8)])
def test_launch_rejects_a_design_that_does_not_take_the_call(design, dtype, C):
    args = _torch(_inputs(2, C, 64, 32), dtype)
    with pytest.raises(ValueError, match="does not take"):
        ops._launch(design, *args)


def test_launch_needs_cuda_tensors():
    before = ops.launches
    with pytest.raises(ValueError, match="run on cuda"):
        ops._launch("stream", *_torch(_inputs(2, 8, 64, 32), "bfloat16"))
    assert ops.launches == before


@pytest.mark.parametrize("E,C,d,f", [(4, 24, 128, 96), (3, 5, 136, 200)])
def test_bf16h_ref_is_the_plain_version_with_h_rounded(E, C, d, f):
    """In float32 the rounding of h is to float32: the plain version's arithmetic."""
    args = _torch(_inputs(E, C, d, f, seed=5), "float32")
    np.testing.assert_allclose(moe_expert_ffn_bf16h_ref(*args).numpy(),
                               moe_expert_ffn_ref(*args).numpy(), atol=1e-6, rtol=1e-5)


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
