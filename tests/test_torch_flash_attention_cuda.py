"""The flash-attention CUDA kernels, each design, held to their plain torch version.

Imports no jax, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_attention_cuda.py

The card tests carry the ``cuda`` marker and skip where there is no card.
Each bf16 design (``ops._launch``) runs every case it takes, so the mma.sync
design is held on the shapes the route sends to the wgmma one.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_ref, ops
from repro_torch.kernels.flash_attention.ref import flash_attention_bf16p_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# a bf16 design against its own arithmetic (flash_attention_bf16p_ref at the design's key
# tile): (atol, rtol) element by element, and ||out - ref|| / ||ref||; K2_BF16P_TOL and
# K2_BF16_NORM of chip_smoke.py, where the readings that set them are described
BF16P_TOL = (4e-3, 1e-2)
BF16_NORM = 5e-4

# the 5 cases of tests/test_kernels.py::test_flash_attention_sweep:
# (B, S, T, H, K, D, causal, window, softcap)
SWEEP = [
    (2, 128, 128, 4, 2, 64, True, None, None),     # GQA causal
    (1, 256, 256, 8, 8, 64, True, 64, None),       # MHA sliding window
    (2, 128, 128, 4, 4, 128, True, None, 50.0),    # softcap (gemma2)
    (1, 128, 128, 2, 1, 64, False, None, None),    # MQA bidirectional
    (1, 192, 192, 4, 2, 64, True, 32, 30.0),       # window + softcap, odd seq
]
# the model paths' shapes and the edges: (B, S, T, H, K, D, causal, window, softcap, q_offset)
SHAPES = [
    (2, 4096, 4096, 8, 4, 256, True, None, None, 0),     # gemma3-4b global layer
    (2, 4096, 4096, 8, 4, 256, True, 1024, None, 0),     # gemma3-4b local layer
    (2, 2048, 2048, 16, 16, 128, True, None, None, 0),   # deepseek-moe-16b
    (1, 1000, 1000, 8, 4, 256, True, 100, None, 0),      # odd S, window < S
    (2, 97, 97, 4, 2, 128, True, None, 30.0, 0),         # S no power of two divides
    (1, 256, 256, 16, 2, 128, True, None, None, 0),      # G = 8
    (2, 64, 200, 4, 2, 64, True, None, None, 136),       # q_offset: a chunk after 136 keys
    (1, 100, 300, 4, 4, 128, True, 50, 50.0, 150),       # q_offset with window and softcap
    (1, 70, 130, 4, 2, 64, False, None, None, 0),        # bidirectional, T > S, tails
    (2, 48, 48, 4, 2, 16, True, 16, None, 0),            # smoke gemma3-4b local layer
    (1, 40, 40, 4, 4, 32, False, None, 20.0, 0),         # D = 32
    (1, 300, 300, 25, 5, 64, True, 128, None, 0),        # hymba-1.5b: G = 5, D = 64, window
    (2, 4224, 4224, 25, 5, 64, True, 1024, None, 0),     # hymba-1.5b's local layer at full
                                                         #   length: S 4096 + 128 meta tokens
    (1, 200, 333, 4, 2, 64, False, None, None, 0),       # T tails, no causal mask, each D
    (2, 130, 77, 4, 4, 128, False, None, None, 0),       #   of the wgmma design
    (1, 129, 203, 8, 4, 256, False, None, 30.0, 0),
]


def _designs(dtype, d):
    """Each design that takes a call of this type and head dim."""
    if dtype == "float32":
        return ["fma"]
    return ["mma", "wgmma"] if d in ops.WGMMA_HEAD_DIMS else ["mma"]


def _cases(shapes, d_at):
    """(dtype, design, *shape) for every design that takes each shape."""
    return [(dtype, design, *shape) for shape in shapes for dtype in DTYPES
            for design in _designs(dtype, shape[d_at])]


def _tol(dtype):
    # the _tol of tests/test_kernels.py
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(B, S, T, H, K, D, dtype, device, seed=0):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=DTYPES[dtype])
            for s in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


def _check(q, k, v, dtype, design, **kw):
    """One design's call against the plain version at _tol and, in bf16, against
    the design's own arithmetic at BF16P_TOL and BF16_NORM."""
    before = ops.launches
    out = ops._launch(design, q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    o = out.float().cpu().numpy()
    ref = flash_attention_ref(q, k, v, **kw).float().cpu().numpy()
    np.testing.assert_allclose(o, ref, atol=_tol(dtype), rtol=_tol(dtype))
    if dtype == "bfloat16":
        tight = flash_attention_bf16p_ref(q, k, v, block_k=ops.block_k(design, q.shape[3]),
                                          **kw).float().cpu().numpy()
        np.testing.assert_allclose(o, tight, atol=BF16P_TOL[0], rtol=BF16P_TOL[1])
        assert np.linalg.norm(o - tight) <= BF16_NORM * np.linalg.norm(tight)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,design,B,S,T,H,K,D,causal,window,softcap", _cases(SWEEP, 5))
def test_kernel_matches_plain_over_the_sweep(B, S, T, H, K, D, causal, window, softcap,
                                             dtype, design):
    _need_cuda()
    q, k, v = _inputs(B, S, T, H, K, D, dtype, "cuda")
    _check(q, k, v, dtype, design, causal=causal, window=window, softcap=softcap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,design,B,S,T,H,K,D,causal,window,softcap,q_offset",
                         _cases(SHAPES, 5))
def test_kernel_matches_plain_at_model_shapes_and_edges(B, S, T, H, K, D, causal, window,
                                                        softcap, q_offset, dtype, design):
    _need_cuda()
    q, k, v = _inputs(B, S, T, H, K, D, dtype, "cuda", seed=1)
    _check(q, k, v, dtype, design, causal=causal, window=window, softcap=softcap,
           q_offset=q_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [("float32", 64), ("bfloat16", 32), ("bfloat16", 64),
                                     ("bfloat16", 128), ("bfloat16", 256)])
def test_route_runs_the_design_it_names(dtype, D):
    """flash_attention launches once, the design ops.route names: the same bits."""
    _need_cuda()
    q, k, v = _inputs(1, 160, 160, 4, 2, D, dtype, "cuda", seed=4)
    before = ops.launches
    out = ops.flash_attention(q, k, v, window=100)
    assert ops.launches == before + 1
    named = ops._launch(ops.route(DTYPES[dtype], D), q, k, v, window=100)
    torch.cuda.synchronize()
    assert torch.equal(out, named)


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["mma", "wgmma"])
def test_kernel_reads_strided_kv_in_place(design):
    """k/v as views of a wider buffer (strides, not a copy) give the same answer."""
    _need_cuda()
    q, k, v = _inputs(2, 256, 256, 8, 4, 128, "bfloat16", "cuda", seed=2)
    wide = torch.zeros(2, 256, 6, 128, dtype=torch.bfloat16, device="cuda")
    wide[:, :, 1:5] = k
    out = ops._launch(design, q, wide[:, :, 1:5], v)
    ref = ops._launch(design, q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,design,D", [("float32", "fma", 64), ("bfloat16", "mma", 64),
                                            ("bfloat16", "wgmma", 64),
                                            ("bfloat16", "wgmma", 256)])
def test_rows_with_no_visible_key_are_zero(dtype, design, D):
    """Rows past T + window see no key: 0, as the Pallas kernel writes them."""
    _need_cuda()
    q, k, v = _inputs(1, 96, 32, 4, 2, D, dtype, "cuda", seed=3)
    out = ops._launch(design, q, k, v, causal=True, window=16)
    torch.cuda.synchronize()
    # row i sees keys (i - 16, i] within [0, 32): none once i >= 47
    assert torch.count_nonzero(out[:, 47:]).item() == 0
    assert torch.count_nonzero(out[:, :47]).item() > 0
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               flash_attention_ref(q, k, v, causal=True,
                                                   window=16).float().cpu().numpy(),
                               atol=_tol(dtype), rtol=_tol(dtype))
