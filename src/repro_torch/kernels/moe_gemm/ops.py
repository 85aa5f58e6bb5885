"""Wrapper of the grouped expert-FFN CUDA kernels.

x (E, C, d); wg, wu (E, d, f); wo (E, f, d), all contiguous and of one type
(float32 or bfloat16), d and f multiples of 8, any C >= 1.  Returns (E, C, d)
in x.dtype.

A CPU tensor goes to the plain version (``ref.moe_expert_ffn_ref``); a CUDA
tensor launches one of three designs (built at first use, see
``repro_torch.kernels.build``; ``route`` picks it) or raises:

* ``"fma"``: float32, any C, fp32 FMA on CUDA cores;
* ``"stream"``: bfloat16, C <= ``STREAM_MAX_C`` (the decode call), a weight
  stream on the tensor cores that reads no weight of an expert whose rows
  are all zero;
* ``"wgmma"``: bfloat16, any C, taken above ``STREAM_MAX_C`` (the prefill
  call), a TMA + wgmma grouped GEMM.

Both bf16 designs round h = silu(x wg) * (x wu) to bf16 between their two
passes, as a chain of bf16 matmuls does (``ref.moe_expert_ffn_bf16h_ref``).
``launches`` counts calls: one a call, whatever the design launches inside.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.moe_gemm.ref import moe_expert_ffn_ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "moe_gemm.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DESIGNS = {"fma": 0, "stream": 1, "wgmma": 2}
#: the largest C the bf16 weight stream takes (ST_MAX_C in moe_gemm.cu: its warps' partial
#: sums fill shared memory there); it is ahead of the GEMM at every C it takes (PERF.md)
STREAM_MAX_C = 16

#: number of kernel calls made by ``moe_expert_ffn`` (CUDA tensors only)
launches = 0


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load("moe_gemm", SOURCES)
    fn = lib.moe_expert_ffn_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, wg, wu, wo) -> None:
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"x must be (E, C, d), got {tuple(x.shape)}")
    e, _, d = x.shape
    if wg.dim() != 3 or wg.shape[:2] != (e, d) or wu.shape != wg.shape:
        raise ValueError(f"wg, wu must both be (E, d, f) = ({e}, {d}, f); got "
                         f"{tuple(wg.shape)}, {tuple(wu.shape)}")
    f = wg.shape[2]
    if wo.shape != (e, f, d):
        raise ValueError(f"wo must be (E, f, d) = ({e}, {f}, {d}); got {tuple(wo.shape)}")
    if d % 8 or f % 8:
        raise ValueError(f"d={d} and f={f} must be multiples of 8")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype for w in (wg, wu, wo)):
        raise TypeError(f"x, wg, wu, wo must share one of {list(_DTYPES)}; got "
                        f"{x.dtype}, {wg.dtype}, {wu.dtype}, {wo.dtype}")
    devs = {t.device for t in (x, wg, wu, wo)}
    if len(devs) != 1:
        raise ValueError(f"x, wg, wu, wo must lie on one device; got {devs}")
    for name, t in (("x", x), ("wg", wg), ("wu", wu), ("wo", wo)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def route(dtype: torch.dtype, c: int) -> str:
    """The design a CUDA call of this type and capacity C runs."""
    if dtype == torch.float32:
        return "fma"
    return "stream" if c <= STREAM_MAX_C else "wgmma"


def moe_expert_ffn(x, wg, wu, wo):
    """x: (E, C, d); wg, wu: (E, d, f); wo: (E, f, d) -> (E, C, d)."""
    refuse_grad("moe_expert_ffn", x, wg, wu, wo)
    _check(x, wg, wu, wo)
    if x.device.type == "cpu":
        return moe_expert_ffn_ref(x, wg, wu, wo)
    return _launch(route(x.dtype, x.shape[1]), x, wg, wu, wo)


def _launch(design: str, x, wg, wu, wo):
    """One design on CUDA tensors.  ``moe_expert_ffn`` takes the one ``route``
    picks; the card tests and chip_smoke.py name each bf16 design, to hold it
    on the shapes the route sends to the other."""
    global launches
    refuse_grad("moe_expert_ffn", x, wg, wu, wo)
    _check(x, wg, wu, wo)
    e, c, d = x.shape
    takes = {"fma": x.dtype == torch.float32, "wgmma": x.dtype == torch.bfloat16,
             "stream": x.dtype == torch.bfloat16 and c <= STREAM_MAX_C}
    if not takes.get(design, False):
        raise ValueError(f"design {design!r} does not take {x.dtype} at C={c}")
    if x.device.type != "cuda":
        raise ValueError(f"the kernels run on cuda, not {x.device}")
    lib = library()
    f = wg.shape[2]
    h = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    occ = torch.empty(e, dtype=torch.int32, device=x.device)   # the stream's expert flags
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.moe_expert_ffn_launch(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wo.data_ptr(),
                                   h.data_ptr(), out.data_ptr(), occ.data_ptr(),
                                   _DTYPES[x.dtype], _DESIGNS[design], e, c, d, f, stream)
    if rc != 0:
        raise RuntimeError(f"moe_expert_ffn ({design}) launch failed: CUDA error {rc}")
    launches += 1
    return out
