"""Wrapper of the decode-attention CUDA kernel, in the model's layout.

q (B, 1, H, D); k, v the KV cache (B, T, K, D), read in place through its
strides; pos (B,) int32 on the same device.  Returns (B, 1, H, D) in q.dtype.

A CPU tensor goes to the plain version (``ref.decode_attention_ref``); a
CUDA tensor launches the kernel (built at first use, see
``repro_torch.kernels.build``) or raises.  One launch a call: the grid is
``n_split`` blocks (one cluster) per (batch, kv head) row, fixed by the
shapes, and each block takes its share of the row's pos + 1 keys on the
device (``ref.split_ranges``).  ``launches`` counts kernel calls.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "decode_attention.cu",)
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8                       # query heads per kv head
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_TILE = 16                     # a split's keys come in runs of this many (UNIT in the source)
MAX_SPLIT = 16                      # splits of a row: the blocks of one cluster
SMEM_LIMIT = 232448                 # dynamic shared memory a block may have (H100)

#: number of kernel calls made by ``decode_attention`` (CUDA tensors only)
launches = 0


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load("decode_attention", SOURCES)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 5 + [i] * 6 + [ll] * 6 + [i]
                       + [ctypes.c_float, ctypes.c_float, p])
        fn.restype = ctypes.c_int
        lib.decode_attention_smem_bytes.argtypes = [i] * 4
        lib.decode_attention_smem_bytes.restype = ctypes.c_int
    return lib


def _check(q, k, v, pos, softcap) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k, v must both be (B, T, K, D) = ({b}, T, K, {d}); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    kh = k.shape[2]
    if h % kh or h // kh > MAX_GROUP:
        raise ValueError(f"H={h} must be a multiple of K={kh} with H/K <= {MAX_GROUP}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; supported: {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if pos.shape != (b,) or pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32 of shape ({b},); got {pos.dtype} "
                        f"{tuple(pos.shape)}")
    devs = {q.device, k.device, v.device, pos.device}
    if len(devs) != 1:
        raise ValueError(f"q, k, v, pos must lie on one device; got {devs}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.device.type == "cuda" and (q.data_ptr() % 16 or not pos.is_contiguous()):
        raise ValueError("q must be 16-byte aligned and pos contiguous")
    if q.device.type == "cuda":
        es = q.element_size()
        for name, x in (("k", k), ("v", v)):
            if x.stride(3) != 1:
                raise ValueError(f"{name} must have unit stride over D")
            if x.data_ptr() % 16 or any(x.stride(i) * es % 16 for i in range(3)):
                raise ValueError(f"{name} must be 16-byte aligned with strides "
                                 f"that are multiples of 16 bytes")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def n_split(rows: int, t: int, g: int, d: int, dtype: torch.dtype, device: torch.device) -> int:
    """Splits of each (batch, kv head) row: about one block per SM over the rows, at most
    MAX_SPLIT (a cluster), no more than the cache has runs of SPLIT_TILE keys, and few enough
    that block 0's slots for the others' partials fit in shared memory.  From the shapes
    only: which keys each split takes is decided on the device from pos."""
    want = min(MAX_SPLIT, -(-_sm_count(device) // rows), -(-t // SPLIT_TILE))
    smem = library().decode_attention_smem_bytes
    while want > 1 and smem(_DTYPES[dtype], d, g, want) > SMEM_LIMIT:
        want -= 1
    return max(want, 1)


def decode_attention(q, k, v, pos, *, softcap: Optional[float] = None):
    """q: (B, 1, H, D); k, v: (B, T, K, D); pos: (B,) int32 -> (B, 1, H, D)."""
    global launches
    refuse_grad("decode_attention", q, k, v)
    _check(q, k, v, pos, softcap)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not {q.device}")
    lib = library()
    b, _, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, t, h, kh, d,
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
        n_split(b * kh, t, h // kh, d, q.dtype, q.device), 1.0 / math.sqrt(d),
        0.0 if softcap is None else float(softcap), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
