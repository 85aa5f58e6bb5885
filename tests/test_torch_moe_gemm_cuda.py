"""The grouped expert-FFN CUDA kernel held to its plain torch version.

Imports no jax, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe_gemm_cuda.py

The card tests carry the ``cuda`` marker and skip where there is no card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.moe_gemm import moe_expert_ffn_ref, ops

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    # tests/test_kernels.py::test_moe_gemm_sweep holds the Pallas kernel at _tol * 4
    return 4 * (2e-2 if dtype == "bfloat16" else 2e-5)


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


# the sweep of tests/test_kernels.py::test_moe_gemm_sweep, the deepseek-moe-16b
# decode call, one more expert count, and C, d, f that no power-of-two tile divides
SHAPES = [(4, 128, 256, 512), (8, 64, 128, 256), (2, 256, 128, 384), (16, 8, 256, 384),
          (64, 8, 2048, 1408), (3, 24, 136, 200), (2, 3, 2056, 8)]


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
    assert out.dtype == x.dtype and out.shape == (E, C, d)
    ref = moe_expert_ffn_ref(x, wg, wu, wo)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=_tol(dtype), rtol=_tol(dtype))


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
def test_kernel_rejects_a_strided_input_on_card():
    _need_cuda()
    x, wg, wu, wo = _inputs(4, 8, 64, 64, "bfloat16", "cuda")
    with pytest.raises(ValueError, match="wg must be contiguous"):
        ops.moe_expert_ffn(x, wg.transpose(1, 2), wu, wo)
