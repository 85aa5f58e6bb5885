"""Wrapper of the grouped expert-FFN CUDA kernel.

x (E, C, d); wg, wu (E, d, f); wo (E, f, d), all contiguous and of one type
(float32 or bfloat16), d and f multiples of 8, any C >= 1.  Returns (E, C, d)
in x.dtype.

A CPU tensor goes to the plain version (``ref.moe_expert_ffn_ref``); a CUDA
tensor launches the kernel (built at first use, see
``repro_torch.kernels.build``) or raises.  ``launches`` counts kernel calls.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gemm.ref import moe_expert_ffn_ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "moe_gemm.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: number of kernel calls made by ``moe_expert_ffn`` (CUDA tensors only)
launches = 0


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load("moe_gemm", SOURCES)
    fn = lib.moe_expert_ffn_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 5 + [p]
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


def moe_expert_ffn(x, wg, wu, wo):
    """x: (E, C, d); wg, wu: (E, d, f); wo: (E, f, d) -> (E, C, d)."""
    global launches
    _check(x, wg, wu, wo)
    if x.device.type == "cpu":
        return moe_expert_ffn_ref(x, wg, wu, wo)
    if x.device.type != "cuda":
        raise ValueError(f"moe_expert_ffn runs on cpu or cuda, not {x.device}")
    lib = library()
    e, c, d = x.shape
    f = wg.shape[2]
    h = torch.empty((e, c, f), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.moe_expert_ffn_launch(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wo.data_ptr(),
                                   h.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], e, c, d, f,
                                   stream)
    if rc != 0:
        raise RuntimeError(f"moe_expert_ffn kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
