"""Wrapper of the RWKV6 wkv-scan CUDA kernel, in the model's layout.

r, k, v (B, T, H, D) of one type (float32 or bfloat16) and logw (B, T, H, D)
float32, each read in place through its strides (unit stride over D); u (H, D)
float32; an optional input state s0 (B, H, D, D) float32.  D is 16, 32, 64 or
128, any T >= 1.  Returns y (B, T, H, D) and the final S (B, H, D, D), both
float32.

A CPU tensor goes to the plain version (``ref.rwkv6_scan_ref``); a CUDA
tensor launches the kernel (built at first use, see
``repro_torch.kernels.build``) or raises.  The kernel cuts the time axis into
segments of ``SEGMENT`` tokens: their local end states, a scan over the
segment boundaries from s0, then every segment's outputs from its incoming
state (``ref.rwkv6_scan_segmented_ref``): three launches when T > SEGMENT,
one otherwise.  ``launches`` counts calls.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.rwkv6_scan.ref import CHUNK, rwkv6_scan_ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu",)
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: tokens of a segment, a multiple of CHUNK: chosen on the H100 (PERF.md §6)
SEGMENT = 256

#: number of kernel calls made by ``rwkv6_scan`` (CUDA tensors only)
launches = 0


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load("rwkv6_scan", SOURCES)
    fn = lib.rwkv6_scan_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 10 + [i] * 6 + [ll] * 12 + [p]
        fn.restype = ctypes.c_int
    return lib


def _check(r, k, v, logw, u, s0) -> None:
    if r.dim() != 4 or min(r.shape) < 1:
        raise ValueError(f"r must be (B, T, H, D), got {tuple(r.shape)}")
    b, _, h, d = r.shape
    if k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape:
        raise ValueError(f"r, k, v, logw must share one shape; got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(logw.shape)}")
    if u.shape != (h, d):
        raise ValueError(f"u must be (H, D) = ({h}, {d}); got {tuple(u.shape)}")
    if s0 is not None and s0.shape != (b, h, d, d):
        raise ValueError(f"s0 must be (B, H, D, D) = ({b}, {h}, {d}, {d}); "
                         f"got {tuple(s0.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; supported: {HEAD_DIMS}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share one of {list(_DTYPES)}; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    f32 = [("logw", logw), ("u", u)] + ([] if s0 is None else [("s0", s0)])
    for name, x in f32:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    devs = {x.device for x in (r, k, v, logw, u) + (() if s0 is None else (s0,))}
    if len(devs) != 1:
        raise ValueError(f"r, k, v, logw, u, s0 must lie on one device; got {devs}")
    if r.device.type == "cuda":
        for name, x in (("u", u), ("s0", s0)):
            if x is not None and (not x.is_contiguous() or x.data_ptr() % 16):
                raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw)):
            if x.stride(3) != 1:
                raise ValueError(f"{name} must have unit stride over D")
            es = x.element_size()
            if x.data_ptr() % 16 or any(x.stride(i) * es % 16 for i in range(3)):
                raise ValueError(f"{name} must be 16-byte aligned with strides "
                                 f"that are multiples of 16 bytes")


def rwkv6_scan(r, k, v, logw, u, s0=None):
    """r, k, v, logw: (B, T, H, D); u: (H, D); s0: (B, H, D, D) or None (zero)
    -> (y (B, T, H, D), S (B, H, D, D)), float32."""
    refuse_grad("rwkv6_scan", r, k, v, logw, u, s0)
    _check(r, k, v, logw, u, s0)
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, logw, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, not {r.device}")
    return _launch(r, k, v, logw, u, s0, SEGMENT)


def _launch(r, k, v, logw, u, s0, segment: int):
    """The kernel at a given segment length (a multiple of CHUNK), on checked CUDA
    tensors; ``rwkv6_scan`` takes SEGMENT, the tools time others."""
    global launches
    refuse_grad("rwkv6_scan", r, k, v, logw, u, s0)
    if segment < CHUNK or segment % CHUNK:
        raise ValueError(f"segment must be a positive multiple of {CHUNK}, got {segment}")
    lib = library()
    b, t, h, d = r.shape
    n_seg = -(-t // segment)
    if n_seg > 65535:
        raise ValueError(f"T={t} makes {n_seg} segments of {segment}; at most 65535")
    y = torch.empty((b, t, h, d), dtype=torch.float32, device=r.device)
    s = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    # the segments' local end states, then (in place) their incoming states; their decays
    seg_state = seg_decay = None
    if n_seg > 1:
        seg_state = torch.empty((n_seg - 1, b, h, d, d), dtype=torch.float32, device=r.device)
        seg_decay = torch.empty((n_seg - 1, b, h, d), dtype=torch.float32, device=r.device)
    strides = [x.stride(i) for x in (r, k, v, logw) for i in range(3)]
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.rwkv6_scan_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                               u.data_ptr(), None if s0 is None else s0.data_ptr(),
                               y.data_ptr(), s.data_ptr(),
                               None if seg_state is None else seg_state.data_ptr(),
                               None if seg_decay is None else seg_decay.data_ptr(),
                               _DTYPES[r.dtype], b, t, h, d, segment, *strides, stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return y, s
