"""The port's plain flash attention and ``layers.attention`` held to the JAX
package on the CPU.

Inputs are made with numpy seeds and handed to both packages.  The JAX
Pallas kernel runs in interpret mode, as ``tests/test_kernels.py`` runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import layers as jlayers
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref, ops
from repro_torch.kernels.flash_attention.ref import flash_attention_bf16p_ref
from repro_torch.models import layers

# the 5 cases of tests/test_kernels.py::test_flash_attention_sweep
SWEEP = [
    (2, 128, 128, 4, 2, 64, True, None, None),     # GQA causal
    (1, 256, 256, 8, 8, 64, True, 64, None),       # MHA sliding window
    (2, 128, 128, 4, 4, 128, True, None, 50.0),    # softcap (gemma2)
    (1, 128, 128, 2, 1, 64, False, None, None),    # MQA bidirectional
    (1, 192, 192, 4, 2, 64, True, 32, 30.0),       # window + softcap, odd seq
]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    # the _tol of tests/test_kernels.py
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(shapes, dtype, seed):
    """numpy draws -> (jax arrays, torch tensors) of the same values in dtype."""
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal(s).astype(np.float32) for s in shapes]
    _, jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


# -- flash_attention_ref ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,softcap", SWEEP)
def test_plain_matches_jax_kernel_and_ref_over_the_sweep(B, S, T, H, K, D, causal, window,
                                                         softcap, dtype):
    (jq, jk, jv), (q, k, v) = _inputs([(B, S, H, D), (B, T, K, D), (B, T, K, D)], dtype, 0)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = flash_attention_ref(q, k, v, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, jflash(jq, jk, jv, **kw, block_q=64, block_k=64, interpret=True), _tol(dtype))
    _close(out, jflash(jq, jk, jv, **kw, impl="ref"), _tol(dtype))


@pytest.mark.parametrize("causal,window,softcap", [(True, None, None), (True, 48, 30.0)])
def test_plain_matches_jax_with_q_offset(causal, window, softcap):
    """A 64-row chunk at positions [128, 192) against 192 keys."""
    (jq, jk, jv), (q, k, v) = _inputs([(2, 64, 4, 64), (2, 192, 2, 64), (2, 192, 2, 64)],
                                      "float32", 1)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=128)
    out = flash_attention_ref(q, k, v, **kw)
    _close(out, jflash(jq, jk, jv, **kw, block_q=64, block_k=64, interpret=True), 2e-5)
    _close(out, jflash(jq, jk, jv, **kw, impl="ref"), 2e-5)


@pytest.mark.parametrize("window", [None, 40])
def test_plain_matches_jax_ref_at_an_odd_length(window):
    """S = T = 97: no power-of-two block divides it (the Pallas kernel asserts
    S % block_q == 0); the port's kernel takes any S."""
    (jq, jk, jv), (q, k, v) = _inputs([(2, 97, 4, 64), (2, 97, 2, 64), (2, 97, 2, 64)],
                                      "float32", 2)
    out = flash_attention_ref(q, k, v, causal=True, window=window)
    _close(out, jflash(jq, jk, jv, causal=True, window=window, impl="ref"), 2e-5)


def test_rows_with_no_visible_key_are_zero_as_in_the_pallas_kernel():
    """S = 128 > T = 64 with window 16: rows from 79 on see no key.  The Pallas
    kernel (and the port) write 0 there; the JAX reference the mean of v."""
    (jq, jk, jv), (q, k, v) = _inputs([(1, 128, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)],
                                      "float32", 3)
    kw = dict(causal=True, window=16)
    out = flash_attention_ref(q, k, v, **kw)
    _close(out, jflash(jq, jk, jv, **kw, block_q=64, block_k=64, interpret=True), 2e-5)
    assert torch.count_nonzero(out[:, 79:]).item() == 0
    jref = _np(jflash(jq, jk, jv, **kw, impl="ref"))
    _close(out[:, :79], jref[:, :79], 2e-5)
    np.testing.assert_allclose(jref[0, 79:, 0], np.broadcast_to(_np(v)[0, :, 0].mean(0),
                                                                 (49, 64)), atol=1e-5)


def test_wrapper_runs_the_plain_version_on_cpu_and_checks_inputs():
    _, (q, k, v) = _inputs([(1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)], "float32", 4)
    before = ops.launches
    out = flash_attention(q, k, v, window=16, softcap=20.0)
    assert ops.launches == before
    assert torch.equal(out, flash_attention_ref(q, k, v, window=16, softcap=20.0))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(TypeError, match="share"):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="multiple of K"):
        flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, q_offset=-1)


# -- the bf16 kernels' own arithmetic, and the route -----------------------------------

# K2_BF16_NORM of chip_smoke.py: a bf16 design's ||out - bf16p|| / ||bf16p|| on the card
BF16_NORM = 5e-4


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,softcap", SWEEP)
def test_bf16p_ref_without_rounding_is_the_jax_reference(B, S, T, H, K, D, causal, window,
                                                         softcap, block_k):
    """With P left unrounded the tiled online softmax is exact attention."""
    (jq, jk, jv), (q, k, v) = _inputs([(B, S, H, D), (B, T, K, D), (B, T, K, D)], "float32", 7)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = flash_attention_bf16p_ref(q, k, v, block_k=block_k, round_p=False, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, jflash(jq, jk, jv, **kw, impl="ref"), 1e-5)


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,softcap", SWEEP)
def test_bf16p_ref_with_rounding_stays_in_the_bf16_hold(B, S, T, H, K, D, causal, window,
                                                        softcap, block_k):
    """P rounded to bf16 moves the output by far less than the kernels' 2e-2
    hold, against the JAX reference and the plain version alike."""
    (jq, jk, jv), (q, k, v) = _inputs([(B, S, H, D), (B, T, K, D), (B, T, K, D)], "bfloat16", 8)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = flash_attention_bf16p_ref(q, k, v, block_k=block_k, **kw)
    assert out.dtype == torch.bfloat16
    _close(out, jflash(jq, jk, jv, **kw, impl="ref"), 2e-2)
    _close(out, flash_attention_ref(q, k, v, **kw), 2e-2)


def test_bf16p_norm_hold_parts_the_plain_version_and_a_dropped_key_tile():
    """The tight norm hold parts the kernels' arithmetic from P kept in fp32
    (the plain version) and from a sum that leaves one 64-key tile out."""
    _, (q, k, v) = _inputs([(1, 256, 4, 64), (1, 2048, 2, 64), (1, 2048, 2, 64)], "bfloat16", 9)
    tight = flash_attention_bf16p_ref(q, k, v, block_k=64, causal=False).float()

    def rel(x):
        return ((x.float() - tight).norm() / tight.norm()).item()
    assert rel(flash_attention_ref(q, k, v, causal=False)) > 2 * BF16_NORM
    keep = torch.cat([torch.arange(0, 1024), torch.arange(1088, 2048)])
    dropped = flash_attention_bf16p_ref(q, k[:, keep], v[:, keep], block_k=64, causal=False)
    assert rel(dropped) > 10 * BF16_NORM


@pytest.mark.parametrize("D", ops.HEAD_DIMS)
def test_route_picks_the_documented_design(D):
    assert ops.route(torch.float32, D) == "fma"
    assert ops.route(torch.bfloat16, D) == ("wgmma" if D in (64, 128, 256) else "mma")
    assert ops.block_k("mma", D) == ops.block_k("fma", D) == 64
    if D in ops.WGMMA_HEAD_DIMS:
        assert ops.block_k("wgmma", D) == (64 if D == 256 else 128)


def test_launch_takes_only_the_calls_its_design_takes():
    _, (q, k, v) = _inputs([(1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32)], "float32", 10)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    for design, args in (("wgmma", (qb, kb, vb)), ("mma", (q, k, v)), ("fma", (qb, kb, vb)),
                         ("sdpa", (q, k, v))):
        with pytest.raises(ValueError, match="does not take"):
            ops._launch(design, *args)
    # a design that takes the call still runs only on CUDA tensors: no CPU fallback
    before = ops.launches
    for design, args in (("fma", (q, k, v)), ("mma", (qb, kb, vb))):
        with pytest.raises(ValueError, match="run on cuda"):
            ops._launch(design, *args)
    assert ops.launches == before
    with pytest.raises(ValueError, match="head dim"):
        ops._launch("mma", qb[..., :24], kb[..., :24], vb[..., :24])


# -- layers.attention ----------------------------------------------------------------

# (B, S, T, H, K, D, Dv, causal, window, softcap, q_block, q_offset)
ATTN = [
    (2, 32, 32, 4, 2, 16, 16, True, None, None, 512, 0),       # one block
    (2, 48, 48, 4, 2, 16, 16, True, None, None, 16, 0),        # three blocks
    (2, 48, 48, 4, 2, 16, 16, True, 12, None, 16, 0),          # window, clipped kstart
    (1, 40, 40, 4, 4, 16, 16, True, 8, 50.0, 16, 0),           # q_block 16 -> 10 (40 % 16)
    (2, 30, 30, 4, 2, 16, 16, True, None, 30.0, 512, 0),       # softcap
    (2, 24, 24, 4, 4, 24, 16, True, None, None, 8, 0),         # dv != d (MLA-like)
    (2, 16, 48, 4, 2, 16, 16, True, None, None, 8, 32),        # q_offset
    (1, 16, 48, 4, 2, 16, 16, True, 10, None, 8, 32),          # q_offset + window
    (2, 32, 32, 4, 2, 16, 16, False, None, None, 8, 0),        # bidirectional
    (2, 1, 20, 4, 2, 16, 16, True, None, None, 512, 11),       # s == 1 fast path
    (2, 1, 20, 4, 2, 16, 16, True, 6, 20.0, 512, 11),          # s == 1 with window
]


@pytest.mark.parametrize("B,S,T,H,K,D,Dv,causal,window,softcap,q_block,q_offset", ATTN)
def test_layers_attention_matches_jax(B, S, T, H, K, D, Dv, causal, window, softcap, q_block,
                                      q_offset):
    (jq, jk, jv), (q, k, v) = _inputs([(B, S, H, D), (B, T, K, D), (B, T, K, Dv)],
                                      "float32", 5)
    kw = dict(causal=causal, window=window, logit_softcap=softcap, q_block=q_block,
              q_offset=q_offset)
    out = layers.attention(q, k, v, **kw)
    assert out.shape == (B, S, H, Dv) and out.dtype == torch.float32
    _close(out, jlayers.attention(jq, jk, jv, **kw), 1e-5)


def test_layers_attention_bf16_scores_match_jax():
    """score_dtype bfloat16 (cfg.attn_scores_dtype): held at the bf16 tolerance."""
    (jq, jk, jv), (q, k, v) = _inputs([(2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)],
                                      "bfloat16", 6)
    kw = dict(causal=True, window=12, q_block=16)
    out = layers.attention(q, k, v, score_dtype=torch.bfloat16, **kw)
    assert out.dtype == torch.bfloat16
    _close(out, jlayers.attention(jq, jk, jv, score_dtype=jnp.bfloat16, **kw), 2e-2)
