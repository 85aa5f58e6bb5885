"""Wrapper of the flash-attention CUDA kernels, in the model's layout.

q (B, S, H, D); k, v (B, T, K, D), each read in place through its strides
(unit stride over D), H a multiple of K.  Returns (B, S, H, D) in q.dtype.

A CPU tensor goes to the plain version (``ref.flash_attention_ref``); a CUDA
tensor launches one of three designs (built at first use, see
``repro_torch.kernels.build``; ``route`` picks it) or raises:

* ``"fma"``: float32, fp32 FMA on CUDA cores, 64-row query tiles;
* ``"wgmma"``: bfloat16 at D in ``WGMMA_HEAD_DIMS`` (every model path), a TMA
  ring and wgmma with producer and consumer warpgroups, 128-row query tiles;
* ``"mma"``: bfloat16 at any D, warp mma.sync over 64-row query tiles; taken
  at D 16 and 32 (smoke configs).

Both bf16 designs round P to bf16 at each key tile's running max before P V,
with key tiles of ``block_k(design, D)`` keys
(``ref.flash_attention_bf16p_ref`` is that arithmetic).  ``launches`` counts
calls.  Every design takes any S and T, so there is no block-size search; the
block skip follows from the host ints S, T, window and q_offset, with no host
sync.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build, refuse_dtensor, refuse_grad
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
HEAD_DIMS = (16, 32, 64, 128, 256)
#: the head dims the bf16 TMA + wgmma design takes (64-column TMA boxes)
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_DESIGNS = {"fma": 0, "mma": 1, "wgmma": 2}

#: number of kernel calls made by ``flash_attention`` (CUDA tensors only)
launches = 0


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load("flash_attention", SOURCES)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p] * 4 + [i] * 7 + [ll] * 9 + [i] * 3 + [f, f, p]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, window, softcap, q_offset) -> None:
    if q.dim() != 4 or min(q.shape) < 1:
        raise ValueError(f"q must be (B, S, H, D), got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or min(k.shape) < 1):
        raise ValueError(f"k, v must both be (B, T, K, D) = ({b}, T, K, {d}); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"H={h} must be a multiple of K={k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; supported: {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1:
        raise ValueError(f"q, k, v must lie on one device; got {devs}")
    if window is not None and not (isinstance(window, int) and window >= 1):
        raise ValueError(f"window must be a positive int or None, got {window!r}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    if not (isinstance(q_offset, int) and q_offset >= 0):
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset!r}")
    if q.device.type == "cuda":
        es = q.element_size()
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.stride(3) != 1:
                raise ValueError(f"{name} must have unit stride over D")
            if x.data_ptr() % 16 or any(x.stride(i) * es % 16 for i in range(3)):
                raise ValueError(f"{name} must be 16-byte aligned with strides "
                                 f"that are multiples of 16 bytes")


def route(dtype: torch.dtype, d: int) -> str:
    """The design a CUDA call of this type and head dim runs."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if d in WGMMA_HEAD_DIMS else "mma"


def block_k(design: str, d: int) -> int:
    """Keys per key tile of a design: the steps of its online softmax."""
    return 64 if design != "wgmma" or d == 256 else 128


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0):
    """q: (B, S, H, D); k, v: (B, T, K, D) -> (B, S, H, D)."""
    refuse_dtensor("flash_attention", q, k, v)
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, window, softcap, q_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                   q_offset=q_offset)
    return _launch(route(q.dtype, q.shape[3]), q, k, v, causal=causal, window=window,
                   softcap=softcap, q_offset=q_offset)


def _launch(design: str, q, k, v, *, causal: bool = True, window: Optional[int] = None,
            softcap: Optional[float] = None, q_offset: int = 0):
    """One design on CUDA tensors.  ``flash_attention`` takes the one ``route``
    picks; the card tests and chip_smoke.py name each bf16 design, to hold and
    time the mma.sync design on the shapes the route sends to the wgmma one."""
    global launches
    refuse_dtensor("flash_attention", q, k, v)
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, window, softcap, q_offset)
    b, s, h, d = q.shape
    takes = {"fma": q.dtype == torch.float32, "mma": q.dtype == torch.bfloat16,
             "wgmma": q.dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS}
    if not takes.get(design, False):
        raise ValueError(f"design {design!r} does not take {q.dtype} at D={d}")
    if q.device.type != "cuda":
        raise ValueError(f"the kernels run on cuda, not {q.device}")
    lib = library()
    t, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DESIGNS[design], b, s, t,
        h, kh, d, q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2), int(causal),
        0 if window is None else window, q_offset, 1.0 / math.sqrt(d),
        0.0 if softcap is None else float(softcap), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({design}) launch failed: CUDA error {rc}")
    launches += 1
    return out
