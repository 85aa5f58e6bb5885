"""The decode-attention CUDA kernel held to its plain torch version.

Imports no jax, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_decode_attention_cuda.py

The card tests carry the ``cuda`` marker and skip where there is no card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import decode_attention_ref, ops
from repro_torch.kernels.decode_attention.ref import (decode_attention_f64_ref,
                                                       decode_attention_split_ref)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# a bf16 call against the exact (float64) attention of its bf16 inputs, element by element:
# rtol bf16's unit roundoff (the output is rounded once), atol the fp32 arithmetic's error
# (chip_smoke.py's K1_BF16X_TOL)
EXACT_TOL = (1e-6, 2.0 ** -8)


def _tol(dtype):
    # the _tol of tests/test_kernels.py
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _holds_exact(out, q, k, v, pos, softcap=None, msg=""):
    """A bf16 output within EXACT_TOL of the exact attention of its inputs."""
    if out.dtype != torch.bfloat16:
        return
    x = decode_attention_f64_ref(q, k, v, pos, softcap=softcap)
    share = (out.double() - x).abs() / (EXACT_TOL[0] + EXACT_TOL[1] * x.abs())
    assert share.max().item() <= 1.0, f"{msg}: {share.max().item():.4g} of EXACT_TOL"


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
        _holds_exact(out, q, k, v, p, softcap, f"pos {p.tolist()}")
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


# the main paths' (K, G, D): gemma3-4b's global layers and deepseek-moe-16b's; hymba-1.5b's G 5
MAIN_KGD = [(4, 2, 256), (16, 1, 128), (5, 5, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,G,D", MAIN_KGD)
def test_kernel_at_every_position_on_card(K, G, D, dtype):
    """A short cache at every pos 0..T-1: one row counts up, the other down."""
    _need_cuda()
    T = 80
    q, k, v, _ = _inputs(2, T, K * G, K, D, dtype, "cuda", seed=2)
    for p in range(T):
        pos = torch.tensor([p, T - 1 - p], dtype=torch.int32, device="cuda")
        out = ops.decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, pos)
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   atol=_tol(dtype), rtol=_tol(dtype), err_msg=f"pos {p}")
        _holds_exact(out, q, k, v, pos, msg=f"pos {p}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,G,D", MAIN_KGD[:2])
def test_kernel_with_pos_straddling_split_edges_on_card(K, G, D, dtype):
    """At max_seq 2048, pos on either side of the runs of 16 keys and of the splits' edges
    (which move with pos), against the plain version and the split mirror."""
    _need_cuda()
    T = 2048
    q, k, v, _ = _inputs(2, T, K * G, K, D, dtype, "cuda", seed=3)
    n = ops.n_split(2 * K, T, G, D, q.dtype, q.device)
    edges = set()
    for p in (16, 32, 48, 256, 1024, 2047):
        ups = -(-(-(-p // ops.SPLIT_TILE)) // n)           # runs a split at pos p - 1
        for s in range(1, n):
            edges.update({s * ups * ops.SPLIT_TILE - 1, s * ups * ops.SPLIT_TILE})
        edges.update({p - 2, p - 1, p})
    edges = sorted(e for e in edges if 0 <= e < T)
    for i in range(0, len(edges) - 1, 2):
        pos = torch.tensor(edges[i:i + 2], dtype=torch.int32, device="cuda")
        out = ops.decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        for ref in (decode_attention_ref(q, k, v, pos),
                    decode_attention_split_ref(q, k, v, pos, n, ops.SPLIT_TILE)):
            np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                                       atol=_tol(dtype), rtol=_tol(dtype),
                                       err_msg=f"pos {edges[i:i + 2]}")
        _holds_exact(out, q, k, v, pos, msg=f"pos {edges[i:i + 2]}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_at_hymba_full_cache_on_card(dtype):
    """hymba-1.5b's full-cache layers as served: T = max_seq 2048 + 128 meta tokens,
    (K 5, G 5, D 64), a token at pos runs at pos + 128 (so pos >= 128 always; the keys at
    [0, 128) are the meta tokens' and count as live), against the plain version, the split
    mirror and, in bf16, the exact attention; pos on both sides of split edges."""
    _need_cuda()
    T, K, G, D, M = 2048 + 128, 5, 5, 64, 128
    q, k, v, _ = _inputs(2, T, K * G, K, D, dtype, "cuda", seed=8)
    n = ops.n_split(2 * K, T, G, D, q.dtype, q.device)
    ups = -(-(-(-T // ops.SPLIT_TILE)) // n)                  # runs a split at the full cache
    edge = ups * ops.SPLIT_TILE
    for p in ([M, M + 1], [M + 15, M + 16], [M + 200, M + 250], [edge - 1, edge],
              [1023 + M, 2047 + M], [T - 1, M]):
        pos = torch.tensor(p, dtype=torch.int32, device="cuda")
        out = ops.decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        for ref in (decode_attention_ref(q, k, v, pos),
                    decode_attention_split_ref(q, k, v, pos, n, ops.SPLIT_TILE)):
            np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                                       atol=_tol(dtype), rtol=_tol(dtype), err_msg=f"pos {p}")
        _holds_exact(out, q, k, v, pos, msg=f"pos {p}")


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("K,G,D", MAIN_KGD[:2])
def test_kernel_bf16_holds_exact_attention_on_card(K, G, D, softcap):
    """bf16 at the main paths' full shapes (each its own key mapping: D 256 and D 128 take
    different lanes a key row and keys a stage) against the float64 attention of the same
    inputs, from the first key to the full cache."""
    _need_cuda()
    T = 2048
    q, k, v, _ = _inputs(2, T, K * G, K, D, "bfloat16", "cuda", seed=7)
    for p in ([0, T - 1], [T - 1, 0], [15, 16], [45, 300], [1023, 1024], [2046, 1777]):
        pos = torch.tensor(p, dtype=torch.int32, device="cuda")
        out = ops.decode_attention(q, k, v, pos, softcap=softcap)
        torch.cuda.synchronize()
        _holds_exact(out, q, k, v, pos, softcap, f"pos {p}")


@pytest.mark.cuda
def test_kernel_replays_in_a_cuda_graph_with_pos_changed_in_place_on_card():
    """One call captured alone; pos rewritten in place between replays (the grid is fixed by
    the shapes, the keys each block takes are read from pos on the device)."""
    _need_cuda()
    q, k, v, _ = _inputs(2, 2048, 8, 4, 256, "bfloat16", "cuda", seed=4)
    pos = torch.tensor([5, 9], dtype=torch.int32, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.decode_attention(q, k, v, pos)                 # build and set attributes first
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = ops.launches
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, pos)
    assert ops.launches == before + 1
    for p in ([0, 2047], [45, 46], [15, 16], [1000, 3], [2047, 2047], [17, 511]):
        pos.copy_(torch.tensor(p, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, pos)
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   atol=_tol("bfloat16"), rtol=_tol("bfloat16"),
                                   err_msg=f"pos {p}")
        _holds_exact(out, q, k, v, pos, msg=f"pos {p}")


@pytest.mark.cuda
def test_kernel_on_two_streams_at_once_on_card():
    """Calls on two streams overlap and keep no state between them: each equals its own call
    alone."""
    _need_cuda()
    args = [_inputs(2, 2048, 16, 16, 128, "bfloat16", "cuda", seed=s) for s in (5, 6)]
    alone = [ops.decode_attention(*a) for a in args]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in args]
    outs = [[], []]
    for _ in range(20):
        for i, (s, a) in enumerate(zip(streams, args)):
            with torch.cuda.stream(s):
                outs[i].append(ops.decode_attention(*a))
    torch.cuda.synchronize()
    for i in range(2):
        for o in outs[i]:
            assert torch.equal(o, alone[i])
