"""The grouped expert-FFN CUDA kernels, each design, held to their plain torch version.

Imports no jax, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe_gemm_cuda.py

The card tests carry the ``cuda`` marker and skip where there is no card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.moe_gemm import moe_expert_ffn_ref, ops
from repro_torch.kernels.moe_gemm.ref import moe_expert_ffn_bf16h_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    # tests/test_kernels.py::test_moe_gemm_sweep holds the Pallas kernel at _tol * 4
    return 4 * (2e-2 if dtype == "bfloat16" else 2e-5)


# a bf16 design against its own arithmetic, h rounded to bf16 (moe_expert_ffn_bf16h_ref):
# (atol, rtol) element by element, and ||out - ref|| / ||ref||; K3_BF16H_TOL and
# K3_BF16H_NORM of chip_smoke.py, where the readings that set them are described
BF16H_TOL = (1e-3, 1e-2)
BF16H_NORM = 2e-3


def _inputs(E, C, d, f, dtype, device, seed=0):
    """Scaled as in tests/test_kernels.py: x * 0.5, weights / sqrt(fan-in)."""
    r = np.random.default_rng(seed)

    def t(shape, scale):
        a = (r.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=DTYPES[dtype])
    return (t((E, C, d), 0.5), t((E, d, f), d ** -0.5), t((E, d, f), d ** -0.5),
            t((E, f, d), f ** -0.5))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


# the sweep of tests/test_kernels.py::test_moe_gemm_sweep; the deepseek-moe-16b decode
# (C 8) and prefill (C 480) calls; C 1 and C 129 (one row past a 128-row tile); both sides
# of the bf16 route threshold; and d, f that no tile divides (d 136, f 200, f 8) at small
# and large C
SHAPES = [(4, 128, 256, 512), (8, 64, 128, 256), (2, 256, 128, 384), (16, 8, 256, 384),
          (64, 8, 2048, 1408), (64, 480, 2048, 1408), (8, 1, 256, 384), (4, 129, 256, 384),
          (8, ops.STREAM_MAX_C, 256, 384), (8, ops.STREAM_MAX_C + 8, 256, 384),
          (3, 24, 136, 200), (2, 3, 2056, 8), (3, 130, 136, 200), (2, 129, 2056, 8)]
BF16_DESIGNS = ("stream", "wgmma")


def _hold(out, x, wg, wu, wo, dtype):
    """out against the plain version at 4 * _tol and, in bf16, against the
    designs' own arithmetic at BF16H_TOL."""
    assert out.dtype == x.dtype and out.shape == x.shape
    ref = moe_expert_ffn_ref(x, wg, wu, wo)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=_tol(dtype), rtol=_tol(dtype))
    if dtype == "bfloat16":
        o = out.float().cpu().numpy()
        tight = moe_expert_ffn_bf16h_ref(x, wg, wu, wo).float().cpu().numpy()
        np.testing.assert_allclose(o, tight, atol=BF16H_TOL[0], rtol=BF16H_TOL[1])
        assert np.linalg.norm(o - tight) <= BF16H_NORM * np.linalg.norm(tight)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", SHAPES)
def test_kernel_matches_plain_on_card(E, C, d, f, dtype):
    _need_cuda()
    x, wg, wu, wo = _inputs(E, C, d, f, dtype, "cuda")
    before = ops.launches
    out = ops.moe_expert_ffn(x, wg, wu, wo)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    _hold(out, x, wg, wu, wo, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("design,E,C,d,f",
                         [(dsn, *shape) for dsn in BF16_DESIGNS for shape in SHAPES
                          if dsn == "wgmma" or shape[1] <= ops.STREAM_MAX_C])
def test_each_bf16_design_matches_plain_on_card(design, E, C, d, f):
    """Each bf16 design on every shape it takes, whatever the route picks."""
    _need_cuda()
    x, wg, wu, wo = _inputs(E, C, d, f, "bfloat16", "cuda", seed=2)
    out = ops._launch(design, x, wg, wu, wo)
    torch.cuda.synchronize()
    _hold(out, x, wg, wu, wo, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_maps_zero_rows_to_zero_on_card(dtype):
    _need_cuda()
    x, wg, wu, wo = _inputs(8, 24, 256, 384, dtype, "cuda", seed=1)
    x[:, 5:17] = 0.0
    out = ops.moe_expert_ffn(x, wg, wu, wo)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[:, 5:17]) == 0
    assert torch.count_nonzero(out[:, :5]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("route,C", [("fma", 8), ("fma", 48), ("stream", 8), ("stream", 16),
                                     ("wgmma", 8), ("wgmma", 48)])
def test_empty_experts_give_exact_zeros_on_card(route, C):
    """Whole experts empty (0.0 and -0.0) beside full ones, and one expert holding a
    single token: the empty ones give exact zeros, the rest are held to the plain version."""
    _need_cuda()
    dtype = "float32" if route == "fma" else "bfloat16"
    x, wg, wu, wo = _inputs(12, C, 512, 384, dtype, "cuda", seed=3)
    x[[1, 5, 9]] = 0.0
    x[[2, 7]] = -0.0
    x[4, 1:] = 0.0                       # one token, not at the last row
    x[10, :-1] = 0.0                     # one token in the last row
    out = ops._launch(route, x, wg, wu, wo)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[[1, 2, 5, 7, 9]]) == 0
    assert torch.count_nonzero(out[4, 0]) > 0 and torch.count_nonzero(out[10, -1]) > 0
    _hold(out, x, wg, wu, wo, dtype)


@pytest.mark.cuda
def test_kernel_rejects_a_strided_input_on_card():
    _need_cuda()
    x, wg, wu, wo = _inputs(4, 8, 64, 64, "bfloat16", "cuda")
    with pytest.raises(ValueError, match="wg must be contiguous"):
        ops.moe_expert_ffn(x, wg.transpose(1, 2), wu, wo)
