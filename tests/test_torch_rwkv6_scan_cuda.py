"""The RWKV6 wkv-scan CUDA kernel held to its plain torch version.

Imports no jax, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_rwkv6_scan_cuda.py

The card tests carry the ``cuda`` marker and skip where there is no card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6_scan import ops, rwkv6_scan_ref, rwkv6_scan_step_ref
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_segmented_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tests/test_kernels.py's tolerances for the Pallas kernel: (atol, rtol)
TOL = (2e-4, 2e-3)
HARD_TOL = (1e-4, 1e-3)


def _inputs(B, T, H, D, dtype, device, seed=0, hard=False):
    """Scaled as in tests/test_kernels.py::test_rwkv6_scan_sweep (r, v ~ N(0, 1),
    k * 0.3, logw = -exp(N * 0.5 - 1) clipped to [1e-4, 8], u * 0.2); hard:
    logw = -8 everywhere, k unscaled, u = 0."""
    g = np.random.default_rng(seed)
    r = g.standard_normal((B, T, H, D))
    k = g.standard_normal((B, T, H, D)) * (1.0 if hard else 0.3)
    v = g.standard_normal((B, T, H, D))
    lw = (np.full((B, T, H, D), -8.0) if hard
          else -np.clip(np.exp(g.standard_normal((B, T, H, D)) * 0.5 - 1.0), 1e-4, 8.0))
    u = np.zeros((H, D)) if hard else g.standard_normal((H, D)) * 0.2

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dt)
    dt = DTYPES[dtype]
    return t(r, dt), t(k, dt), t(v, dt), t(lw), t(u)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


def _close(out, ref, tol):
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=tol[0], rtol=tol[1])


# the sweep of tests/test_kernels.py::test_rwkv6_scan_sweep, then T % 16 != 0, the smoke
# config's head dim, D 128, and rwkv6-3b's prefill shape cut to T 512
SHAPES = [(2, 64, 4, 64), (1, 48, 2, 32), (2, 80, 3, 64), (2, 37, 3, 64), (1, 1, 2, 32),
          (2, 24, 4, 16), (1, 40, 2, 128), (2, 512, 40, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,D", SHAPES)
def test_kernel_matches_plain_on_card(B, T, H, D, dtype):
    _need_cuda()
    r, k, v, lw, u = _inputs(B, T, H, D, dtype, "cuda")
    before = ops.launches
    y, s = ops.rwkv6_scan(r, k, v, lw, u)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (B, T, H, D) and s.shape == (B, H, D, D)
    ey, es = rwkv6_scan_ref(r, k, v, lw, u)
    _close(y, ey, TOL)
    _close(s, es, TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_hard_decay_on_card(dtype):
    _need_cuda()
    r, k, v, lw, u = _inputs(1, 64, 2, 32, dtype, "cuda", hard=True)
    y, s = ops.rwkv6_scan(r, k, v, lw, u)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    ey, es = rwkv6_scan_ref(r, k, v, lw, u)
    _close(y, ey, HARD_TOL)
    _close(s, es, HARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 45])
def test_kernel_carries_input_state_on_card(T):
    """A non-zero s0, at a T no chunk divides: equal to the per-token recurrence."""
    _need_cuda()
    r, k, v, lw, u = _inputs(2, T, 3, 64, "float32", "cuda", seed=3)
    s0 = torch.randn((2, 3, 64, 64), generator=torch.Generator().manual_seed(4)).cuda()
    y, s = ops.rwkv6_scan(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    ey, es = rwkv6_scan_step_ref(r, k, v, lw, u, s0)
    _close(y, ey, TOL)
    _close(s, es, TOL)
    y0, _ = ops.rwkv6_scan(r, k, v, lw, u)
    assert (y - y0).abs().max() > 1e-2


@pytest.mark.cuda
def test_kernel_reads_the_model_layout_by_strides_on_card():
    """r, k, v, logw as views of wider (B, T, H * D + 64) rows give the same
    result as contiguous copies."""
    _need_cuda()
    r, k, v, lw, u = _inputs(2, 40, 4, 32, "bfloat16", "cuda", seed=5)

    def widen(x):
        w = torch.zeros((2, 40, 4 * 32 + 64), dtype=x.dtype, device=x.device)
        w[..., :128] = x.reshape(2, 40, 128)
        return w[..., :128].unflatten(-1, (4, 32))
    views = [widen(x) for x in (r, k, v, lw)]
    assert not views[0].is_contiguous()
    y, s = ops.rwkv6_scan(*views, u)
    y2, s2 = ops.rwkv6_scan(r, k, v, lw, u)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.cuda
def test_kernel_rejects_a_strided_head_dim_on_card():
    _need_cuda()
    r, k, v, lw, u = _inputs(1, 16, 2, 32, "float32", "cuda")
    with pytest.raises(ValueError, match="unit stride over D"):
        ops.rwkv6_scan(r.transpose(2, 3).contiguous().transpose(2, 3), k, v, lw, u)


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, ops.SEGMENT - 1, ops.SEGMENT, ops.SEGMENT + 1,
                               3 * ops.SEGMENT + 5])
def test_kernel_around_the_segment_length_on_card(T, dtype, with_state):
    """T on either side of a segment's end and across several, from a zero or a non-zero
    state: held to the plain version and to the segment decomposition's mirror."""
    _need_cuda()
    r, k, v, lw, u = _inputs(2, T, 4, 64, dtype, "cuda", seed=T)
    s0 = (torch.randn((2, 4, 64, 64), generator=torch.Generator().manual_seed(T)).cuda()
          if with_state else None)
    y, s = ops.rwkv6_scan(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    for ey, es in (rwkv6_scan_ref(r, k, v, lw, u, s0),
                   rwkv6_scan_segmented_ref(r, k, v, lw, u, s0, seg=ops.SEGMENT)):
        _close(y, ey, TOL)
        _close(s, es, TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("segment", [16, 48, 128, 512])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_kernel_at_other_segment_lengths_on_card(segment, D):
    """Every head dim at segments from one chunk up, T = 517 (no segment divides it)."""
    _need_cuda()
    r, k, v, lw, u = _inputs(1, 517, 2, D, "bfloat16", "cuda", seed=D + segment)
    s0 = torch.randn((1, 2, D, D), generator=torch.Generator().manual_seed(D)).cuda()
    y, s = ops._launch(r, k, v, lw, u, s0, segment)
    torch.cuda.synchronize()
    ey, es = rwkv6_scan_ref(r, k, v, lw, u, s0)
    _close(y, ey, TOL)
    _close(s, es, TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_hard_decay_across_segments_on_card(dtype):
    """logw = -8 over 3 segments and a tail, from a non-zero state: each segment's decay
    underflows to 0."""
    _need_cuda()
    T = 3 * ops.SEGMENT + 5
    r, k, v, lw, u = _inputs(1, T, 2, 32, dtype, "cuda", hard=True)
    s0 = torch.randn((1, 2, 32, 32), generator=torch.Generator().manual_seed(1)).cuda()
    y, s = ops.rwkv6_scan(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    ey, es = rwkv6_scan_ref(r, k, v, lw, u, s0)
    _close(y, ey, HARD_TOL)
    _close(s, es, HARD_TOL)


@pytest.mark.cuda
def test_kernel_through_the_model_strides_across_segments_on_card():
    """r, k, v, logw as the model makes them (views of (B, T, H * D) projections) over
    several segments, with the cache's state: equal to contiguous copies and to the plain
    version."""
    _need_cuda()
    T, H, D = 2 * ops.SEGMENT + 24, 6, 64
    r, k, v, lw, u = _inputs(2, T, H, D, "bfloat16", "cuda", seed=7)

    def widen(x):
        w = torch.zeros((2, T, H * D + 64), dtype=x.dtype, device=x.device)
        w[..., :H * D] = x.reshape(2, T, H * D)
        return w[..., :H * D].unflatten(-1, (H, D))
    views = [widen(x) for x in (r, k, v, lw)]
    s0 = torch.randn((2, H, D, D), generator=torch.Generator().manual_seed(2)).cuda()
    y, s = ops.rwkv6_scan(*views, u, s0)
    y2, s2 = ops.rwkv6_scan(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s, s2)
    ey, es = rwkv6_scan_ref(r, k, v, lw, u, s0)
    _close(y, ey, TOL)
    _close(s, es, TOL)
