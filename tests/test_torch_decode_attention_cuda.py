"""The decode-attention CUDA kernel held to its plain torch version.

Imports no jax, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_decode_attention_cuda.py

The card tests carry the ``cuda`` marker and skip where there is no card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import decode_attention_ref, ops

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    # the _tol of tests/test_kernels.py
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(B, T, H, K, D, dtype, device, seed=0):
    r = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
               .to(device=device, dtype=DTYPES[dtype])
               for s in ((B, 1, H, D), (B, T, K, D), (B, T, K, D)))
    pos = torch.from_numpy(r.integers(1, T, B).astype(np.int32)).to(device)
    return q, k, v, pos


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


def _respects_position(fn, device):
    """Keys beyond pos must not influence the output."""
    q, k, v, _ = _inputs(2, 128, 4, 2, 64, "float32", device, seed=1)
    pos = torch.tensor([40, 90], dtype=torch.int32, device=device)
    base = fn(q, k, v, pos)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 999.0
    v2[:, 100:] = -999.0
    out = fn(q, k2, v2, pos)
    np.testing.assert_allclose(base.cpu().numpy(), out.cpu().numpy(), atol=1e-6)


def test_plain_respects_position():
    _respects_position(decode_attention_ref, "cpu")


@pytest.mark.cuda
def test_kernel_respects_position_on_card():
    _need_cuda()
    _respects_position(ops.decode_attention, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,K,D,softcap", [
    (2, 256, 4, 2, 64, None),
    (1, 512, 8, 1, 128, None),
    (3, 128, 6, 6, 64, 50.0),
    (2, 2048, 8, 4, 256, None),     # gemma3-4b global layer at max_seq 2048
    (2, 2048, 8, 4, 256, 50.0),
    (2, 48, 4, 2, 16, None),        # smoke gemma3-4b
    (1, 100, 2, 1, 32, None),       # T not a multiple of the tile
])
def test_kernel_matches_plain_on_card(B, T, H, K, D, softcap, dtype):
    _need_cuda()
    q, k, v, pos = _inputs(B, T, H, K, D, dtype, "cuda")
    before = ops.launches
    for p in (pos, torch.zeros_like(pos), torch.full_like(pos, T - 1)):
        out = ops.decode_attention(q, k, v, p, softcap=softcap)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, p, softcap=softcap)
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   atol=_tol(dtype), rtol=_tol(dtype))
    assert ops.launches == before + 3


@pytest.mark.cuda
def test_kernel_reads_a_strided_cache_in_place():
    """k/v as views of a wider buffer (strides, not a copy) give the same answer."""
    _need_cuda()
    q, k, v, pos = _inputs(2, 256, 8, 4, 128, "bfloat16", "cuda")
    wide = torch.zeros(2, 256, 6, 128, dtype=torch.bfloat16, device="cuda")
    wide[:, :, 1:5] = k
    out = ops.decode_attention(q, wide[:, :, 1:5], v, pos)
    ref = ops.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
