#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, prefill and training paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the kernels are built from the sources in this
checkout at first use) and the repository's ``src/`` beside this file; it
exits non-zero without them.  Imports torch, numpy and ``repro_torch`` only.

Phases, one line of output each, with their wall seconds (``env`` prints the
card's name and power limit as nvidia-smi gives them on a line of its own):
  env             card, torch and CUDA versions; TF32 off for matmul and cuDNN
  build           nvcc of every kernel, all started together (process set-up,
                  apart from cold starts), with ptxas's register/spill lines
  kernel          decode_attention (K1) against its plain torch version at
                  gemma3-4b's, deepseek-moe-16b's and hymba-1.5b's decode
                  shapes; its registers and spills; its time, the plain time,
                  SDPA's time and the least time the card could take for the
                  same work, at gemma3-4b's and hymba-1.5b's shapes, at the
                  full cache and at two serving positions, and at all three
                  shapes at the decode profiles' positions (both slots at 45)
  kernel.moe_gemm the grouped expert FFN (K3) against its plain version in
                  every design (the route each shape takes is printed; bf16
                  shapes with C <= 16 also through the other design), and
                  each bf16 design also against its own arithmetic (h
                  rounded to bf16) at tight tolerances; zero rows and empty
                  experts (0.0 and -0.0) exact, a lone token computed; at
                  deepseek-moe-16b's decode call (C = 8: dense, and 12 of 64
                  experts holding a token) and prefill call (C = 480) its
                  time, the plain time, a cuBLAS bmm chain's time and the
                  bound
  kernel.flash_attention
                  flash attention (K2) against its plain version in every
                  design (the route each shape takes is printed; bf16 shapes
                  at D 64, 128 and 256 also through the mma.sync design) over
                  the sweep of tests/test_kernels.py, the model paths' shapes,
                  an odd S and a q_offset, and each bf16 design also against
                  its own arithmetic (P rounded to bf16 at each key tile's
                  running max) at tight tolerances; rows that see no key
                  exact 0; the wgmma kernels' registers and spills from the
                  build log (no spill allowed); at gemma3-4b's global and
                  local, deepseek-moe-16b's and hymba-1.5b's global and local
                  prefill shapes both bf16 designs' times in turns, the plain
                  time, SDPA's time (and backend) and the bound; the host time
                  of a call
  kernel.rwkv6_scan
                  the wkv scan (K4) against its plain version in f32 and bf16
                  over the sweep of tests/test_kernels.py, the hard decay
                  (logw = -8), a T no chunk divides, a non-zero input state
                  and rwkv6-3b's prefill shape; its kernels' registers and
                  spills; at that shape its time per call and per pass, the
                  plain time and the bound (no single PyTorch call computes
                  it)
  model           one full-width replica (bf16) per arch: gemma3-4b,
                  deepseek-moe-16b, deepseek-v2-lite-16b (MLA), rwkv6-3b,
                  hymba-1.5b, whisper-tiny: parameter
                  count, bytes, cold start, decode-step time, kernel launches
                  per step, a profiled decode step (device busy time against
                  host wall time); one step checked: each kernel call in it
                  against its plain version on the model's own inputs, and
                  its logits against the model with plain versions in the
                  kernels' place and with attn_impl="ref" (held on the dense
                  arch; reported, with routing flips, on the moe archs)
  serve           ControlPlane + TorchWorkerBackend over full-width replicas
                  of gemma3-4b, then of deepseek-moe-16b, rwkv6-3b,
                  hymba-1.5b and whisper-tiny (rwkv6-3b and hymba-1.5b with
                  more requests than slots: reused slots start from a zeroed
                  recurrent state, hymba's attention caches left as they
                  are); each kernel's launch count must be its launches per
                  step x the decode steps taken (whisper reaches none)
  prefill         registry.prefill at full width (bf16): gemma3-4b at B 2,
                  S 4096, then deepseek-moe-16b and deepseek-v2-lite-16b at
                  B 2, S 2048 (4096 tokens, one dispatch group), then
                  rwkv6-3b at B 2, S 4096 (32 K4 calls): launches per
                  prefill, every kernel call held to its plain version, wall
                  time, tokens/s, device busy time, peak memory, logits
                  against attn_impl="ref" (held on the dense arch); on
                  gemma3-4b and rwkv6-3b also 8 decode steps from the filled
                  caches, held to registry.forward over the S + 8 tokens
                  (4104: K4's tail masking).  rwkv6-3b's bf16 prefill
                  logits are reported (tools/rwkv6_drift.py measures why
                  they are no check at full depth); then the phase in
                  float32 at full width and 8 layers holds its logits and
                  decode steps within 1e-3; hymba-1.5b at B 2, S 4096 (+ its
                  128 meta tokens: K2 x 32 at S 4224) with 8 decode steps
                  held to forward and the plain per-token selective_scan's
                  share of the profiled prefill (device and host); whisper-
                  tiny at B 2, S 440 (+ 8 decode steps: its 448-token text
                  context) over 1500 random frame embeddings
  train           gemma3-4b through train_step at full width and depth:
                  float32 parameters and AdamW state, bf16 compute, every
                  layer checkpointed, attn_impl="ref" (the kernels are
                  forward only), B 1, S 4096, 4 optimizer steps: step 0's
                  chunked loss held to the cross entropy of the full logits,
                  losses and grad norms finite, the parameters moved by step
                  1; step wall, tokens/s, peak memory, the optimizer's share
                  of the step, and a fifth step under the profiler (device
                  busy, idle share, top device ops)
  train.family    every family's smoke config in float32, 3 steps at lr
                  1e-4 on the card and 3 on the CPU from one CPU-made init:
                  the first gradients and the final parameters within 1e-4
                  of each leaf's largest entry, losses within rtol 1e-4; no
                  kernel launched
  train.restart   the dense smoke config: 4 steps against 2 steps, a
                  checkpoint, a restore into fresh state and 2 more, bit for
                  bit under torch.use_deterministic_algorithms
  train.no_kernel_grad
                  K1-K4 (K2, K3 and K4 also through _launch) raise on CUDA
                  inputs that require grad and launch under no_grad; a
                  training step under attn_impl="kernel" raises
Then one JSON line of per-kernel numbers, and last the result line
``{"ok": true, "device": {...}}``.  Any failure ends the run non-zero.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # the _tol of tests/test_kernels.py

# K1's shapes on the main paths, (B, T, H, K, D): 2 slots (= container
# concurrency) at max_seq 2048; gemma3-4b's global layers, deepseek-moe-16b's
K1_GEMMA = (2, 2048, 8, 4, 256)
K1_MOE = (2, 2048, 16, 16, 128)
MAX_SLOTS, MAX_SEQ = 2, 2048
# hymba-1.5b's 3 full-cache layers: G 5 at D 64, over max_seq + its 128 meta tokens; a
# served token at pos runs at pos + 128
HYMBA_META = 128
K1_HYMBA = (2, MAX_SEQ + HYMBA_META, 25, 5, 64)
# the profiled decode steps (model.profile) run both slots at pos 40, ..., 49: K1 is
# timed with both at the middle one
K1_PROFILE_POS = [45, 45]
# a bf16 K1 call against the exact (float64) attention of its bf16 inputs, element by element:
# rtol bf16's unit roundoff 2^-8 (the output is rounded once), atol the fp32 arithmetic's
# error (the f32 calls read <= 1.5e-7 against the plain version at both shapes)
K1_BF16X_TOL = (1e-6, 2.0 ** -8)
# K3's decode call in deepseek-moe-16b and deepseek-v2-lite: (E, C, d, f)
K3_DECODE = (64, 8, 2048, 1408)
# and its prefill call at B 2, S 2048: one group of 4096 tokens, C = _capacity = 480
K3_PREFILL = (64, 480, 2048, 1408)
K3_SHAPES = [K3_DECODE, (4, 128, 256, 512), (8, 64, 128, 256), (2, 256, 128, 384),
             (64, 24, 2048, 1408), K3_PREFILL,   # the sweep of tests/test_kernels.py; C = 24
             (3, 130, 136, 200), (2, 3, 2056, 8)]   # d, f that no tile divides
# the decode call at 2 slots: 2 tokens x top-6 occupy 12 of the 64 experts
K3_OCCUPIED = 12
# K3's bf16 designs against their own arithmetic (ref.moe_expert_ffn_bf16h_ref, h rounded to
# bf16, float64 sums).  The two differ by the order of fp32 sums: one bf16 step of an output
# (2^-8 to 2^-7 of it) where a sum lands near a rounding boundary, and one step of an h where
# an h does, which a near-zero output built from large h * wo terms can show many times over.
# Element by element, (atol, rtol): the kernels' random inputs read at most 0.71 of it on the
# H100, the plain version (h in fp32) up to 1.23, out * 1.02 1.65-1.87.  On the models' own
# prefill inputs (|h| up to 16) a correct fp32 torch chain reads up to 2.2 of it against the
# float64 one, and the kernels 2.8-4.5: reported there, not held.  The whole output,
# ||out - ref|| / ||ref||, held everywhere: the kernels read 5.0e-4 on those inputs, the
# plain version 2.6e-3, out * 1.02 2e-2.
K3_BF16H_TOL = (1e-3, 1e-2)
K3_BF16H_NORM = 2e-3
# K2: the 5 cases of tests/test_kernels.py::test_flash_attention_sweep, then the
# model paths' shapes and the edges: (B, S, T, H, K, D, causal, window, softcap, q_offset)
K2_SHAPES = [
    (2, 128, 128, 4, 2, 64, True, None, None, 0),
    (1, 256, 256, 8, 8, 64, True, 64, None, 0),
    (2, 128, 128, 4, 4, 128, True, None, 50.0, 0),
    (1, 128, 128, 2, 1, 64, False, None, None, 0),
    (1, 192, 192, 4, 2, 64, True, 32, 30.0, 0),
    (2, 4096, 4096, 8, 4, 256, True, None, None, 0),     # gemma3-4b global layer
    (2, 4096, 4096, 8, 4, 256, True, 1024, None, 0),     # gemma3-4b local layer
    (2, 2048, 2048, 16, 16, 128, True, None, None, 0),   # deepseek-moe-16b
    (1, 1000, 1000, 8, 4, 256, True, 100, None, 0),      # odd S
    (2, 64, 200, 4, 2, 64, True, None, None, 136),       # q_offset: a chunk after 136 keys
    (2, 4224, 4224, 25, 5, 64, True, None, None, 0),     # hymba-1.5b global layer: S 4096
    (2, 4224, 4224, 25, 5, 64, True, 1024, None, 0),     # + 128 meta tokens; local layer
]
K2_GLOBAL, K2_LOCAL, K2_MOE = K2_SHAPES[5], K2_SHAPES[6], K2_SHAPES[7]
K2_HYMBA_GLOBAL, K2_HYMBA_LOCAL = K2_SHAPES[10], K2_SHAPES[11]
# K2's bf16 designs against their own arithmetic (ref.flash_attention_bf16p_ref at the
# design's key tile: P rounded to bf16 at the tile's running max, float64 sums).  They differ
# from it by the order of fp32 sums and the fp32 scores and exponent: one bf16 step of an
# output where it lands near a rounding boundary, and one step of a p where a p does, which
# in the first rows of a causal call (a few keys, p / l near 1) moves an output by up to
# 2^-8 |v|: 0.0029 at |out| ~ 0.01 in the global layer, so atol 1e-3 fails the mma.sync
# design there.  Element by element, (atol, rtol): over K2_SHAPES on the H100 the mma.sync
# design reads at most 0.531 of it (max |err| 0.0078), the wgmma design 0.525 (0.0039).
# The whole output, ||out - ref|| / ||ref||: mma.sync at most 1.51e-4, wgmma 1.83e-4
# (1.21x), on the models' own K2 calls 1.44e-4; the plain version (P in fp32) reads 1.88e-3
# to 2.30e-3 against it, and a sum that leaves out one 64-key tile of 2048 reads 0.19
# (tests/test_torch_flash_attention.py).
K2_BF16P_TOL = (4e-3, 1e-2)
K2_BF16_NORM = 5e-4
# K4: the 3 cases of tests/test_kernels.py::test_rwkv6_scan_sweep, T % 16 != 0 (a short
# one and the forward over rwkv6-3b's prefill + 8 decode tokens), then the model shape:
# rwkv6-3b's prefill call (B, T, H, D); K4_STATE run from a non-zero input state
K4_SHAPES = [(2, 64, 4, 64), (1, 48, 2, 32), (2, 80, 3, 64), (2, 37, 3, 64), (2, 4104, 40, 64),
             (2, 4096, 40, 64)]
K4_MODEL = K4_SHAPES[-1]
K4_STATE = [(2, 45, 40, 64), K4_MODEL]
K4_HARD = (1, 64, 2, 32)              # tests/test_kernels.py::test_rwkv6_hard_decay_stability
# tests/test_kernels.py's tolerances for the Pallas kernel, (atol, rtol); K4's output is
# fp32 whatever its inputs, computed in fp32 by both versions from the same inputs
K4_TOL, K4_HARD_TOL = (2e-4, 2e-3), (1e-4, 1e-3)
PREFILL_B, PREFILL_S_GEMMA, PREFILL_S_MOE, DECODE_AFTER = 2, 4096, 2048, 8
# whisper-tiny's prompt: its decoder's 448-token text context less the decode steps
PREFILL_S_WHISPER = 448 - DECODE_AFTER
# the cache entries a family's reset_slot zeroes: every one (ssm), the Mamba state (hybrid)
RECURRENT = {"ssm": "all", "hybrid": ("ssm_h", "conv")}
# the profiler range around hymba's plain per-token scan in its profiled prefill
SCAN_RANGE = "hymba.selective_scan"
# relative bounds (max |diff| / max |logit|) of the dense arch's bf16 logits:
# prefill with the kernels against attn_impl="ref", and decode after prefill
# against one forward over all the tokens.  Both sides compute attention in
# fp32 but round to bf16 at other places (other kernels, other GEMM shapes),
# and one-ulp differences grow through 34 layers: 0.009-0.011 on the H100 at
# full width, 0.016-0.027 on the CPU for narrow 34-layer bf16 gemma3 models,
# while decoding one position off gives 0.30 there.
PREFILL_VS_REF_BOUND = DECODE_VS_FORWARD_BOUND = 5e-2
# rwkv6-3b's random-weight model at full width makes its prefill logits no such check at
# full depth: a 1e-6 relative perturbation of the wkv outputs grows layer by layer, so
# two correct paths differ by as much as the kernel and ref paths do, in bf16 and in
# float32 alike (tools/rwkv6_drift.py measures this noise floor over seeds, and where
# it comes from).  Its prefill logits are held in float32 at full width with the depth
# cut to RWKV_HELD_LAYERS, with its decode steps, where that script reads a floor far
# below F32_LOGITS_BOUND and a path off by a token, a chunk or the state is O(1) off; at
# full depth its decode steps are held as gemma3-4b's are.
RWKV_HELD_LAYERS = 8
F32_LOGITS_BOUND = 1e-3


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def time_ms(fn, iters: int = 50) -> float:
    """Median device time of one call, L2 flushed before each (a decode step
    streams GBs of weights between two calls of one layer).  The 1 GiB flush
    also keeps the card busy (~0.3 ms) while the host enqueues the call, so
    the events time the device, not the host's launch overhead."""
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def loaded_clock(fn, n: int = 200) -> str:
    """The card's SM clock and power draw as nvidia-smi reads them while n
    calls of fn, enqueued ahead, keep it busy (a card at its power limit
    lowers its clock, by how much depends on the data)."""
    for _ in range(n):
        fn()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return smi


def bound(nbytes: int, nops: int, dtype) -> tuple[float, str]:
    """Least time (ms) for the work, and which of bytes or operations sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ptxas_usage(log: str, name: str) -> list[dict]:
    """Registers and spill bytes of every kernel whose mangled name holds
    ``name``, from a build's ``-Xptxas -v`` log."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = dict(kernel=ln.split("'")[1]) if name in ln else None
            if cur is not None:
                out.append(cur)
        elif cur is not None and "spill stores" in ln:
            fields = [x.strip().split(" ")[0] for x in ln.split(",")]
            cur.update(stack=int(fields[0]), spill_stores=int(fields[1]),
                       spill_loads=int(fields[2]))
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(ln.split("Used")[1].split("registers")[0])
    return out


def ptxas_phase(ops, lib: str, name: str, label: str) -> list[dict]:
    """Print the registers and spills ptxas reported for every kernel of library ``lib``
    whose name holds ``name`` (one line each, phase ``label``) -> the readings."""
    log = ops.build.library_path(lib, ops.SOURCES).with_suffix(".log").read_text()
    usage = ptxas_usage(log, name)
    for u in usage:
        phase(label, **u)
    if not usage:
        raise AssertionError(f"the build log of {lib} names no {name}")
    return usage


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


class ReplicaCap:
    """A fleet for ControlPlane's capacity hook: at most ``n`` live replicas;
    creates beyond it are deferred until one is torn down."""

    def __init__(self, n: int):
        self.n = n

    def tick(self, now: float, live: int) -> None:
        pass

    def can_create(self, live: int) -> bool:
        return live < self.n

    def snapshot(self) -> dict:
        return {"max_replicas": self.n}


def env_phase() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("env", card=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0], tf32="off (matmul and cudnn)")
    return smi


def build_phase(kernels: dict) -> None:
    """One nvcc per kernel source, all started together."""
    def build(ops):
        t0 = time.monotonic()
        lib = ops.library()
        return lib, time.monotonic() - t0
    with ThreadPoolExecutor(len(kernels)) as pool:
        built = dict(zip(kernels, pool.map(build, kernels.values())))
    for name, ops in kernels.items():
        lib, secs = built[name]
        log = ops.build.library_path(name, ops.SOURCES).with_suffix(".log")
        usage = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln] if log.exists() else []
        phase("build", kernel=name, seconds=f"{secs:.2f}", lib=Path(lib._name).name,
              ptxas=repr(" | ".join(usage[:12])))


def k1_checks(ops, ref_fn, exact_fn, shape, gen, tight: dict) -> float:
    """decode_attention against its plain version at one shape: f32 and bf16,
    softcap off and on, pos at 0, T-1 and random; garbage past pos.  Each bf16
    call, and its plain version beside it, also against the exact attention
    (exact_fn, float64) at K1_BF16X_TOL; the largest readings go into tight."""
    b, t, h, kh, d = shape
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, 1, h, d, generator=gen, device=DEVICE).to(dtype)
        k = torch.randn(b, t, kh, d, generator=gen, device=DEVICE).to(dtype)
        v = torch.randn(b, t, kh, d, generator=gen, device=DEVICE).to(dtype)
        rand = torch.randint(1, t - 1, (b,), generator=gen, device=DEVICE)
        for softcap in (None, 50.0):
            for pos in ([0, t - 1], [t - 1, 0], rand.tolist()):
                p = torch.tensor(pos, dtype=torch.int32, device=DEVICE)
                out = ops.decode_attention(q, k, v, p, softcap=softcap)
                torch.cuda.synchronize()
                exp = ref_fn(q, k, v, p, softcap=softcap)
                if not torch.isfinite(out).all():
                    raise AssertionError(f"non-finite kernel output {dtype} {softcap} {pos}")
                err = (out.float() - exp.float()).abs().max().item()
                torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                                           rtol=TOL[dtype])
                worst = max(worst, err)
                exact = {}
                if dtype == torch.bfloat16:
                    x = exact_fn(q, k, v, p, softcap=softcap)
                    exact = {"kernel": tight_reading(out, x, K1_BF16X_TOL, "bf16x"),
                             "plain": tight_reading(exp, x, K1_BF16X_TOL, "bf16x")}
                    for who, reading in exact.items():
                        for key, val in reading.items():
                            tight[who][key] = max(tight[who].get(key, 0.0), val)
                phase("kernel.check", shape=shape, dtype=str(dtype).split(".")[1],
                      softcap=softcap, pos=pos, max_abs_err=f"{err:.3g}", tol=TOL[dtype],
                      **{f"exact_{who}": {key: f"{val:.4g}" for key, val in reading.items()}
                         for who, reading in exact.items()})
                if exact and exact["kernel"]["bf16x_tol_share"] > 1.0:
                    raise AssertionError(f"bf16 K1 {shape} softcap={softcap} pos={pos} is "
                                         f"off the exact attention at {K1_BF16X_TOL}: {exact}")
        # garbage past pos leaves the output unchanged (keys past pos are never read)
        p = torch.tensor([40, 90], dtype=torch.int32, device=DEVICE)
        base = ops.decode_attention(q, k, v, p)
        k2, v2 = k.clone(), v.clone()
        k2[:, 100:] = 999.0
        v2[:, 100:] = -999.0
        moved = (ops.decode_attention(q, k2, v2, p).float() - base.float()).abs().max().item()
        if moved > 1e-6:
            raise AssertionError(f"keys past pos changed the output by {moved}")
        phase("kernel.position", shape=shape, dtype=str(dtype).split(".")[1],
              garbage_past_pos_moved=moved)
    return worst


def kernel_phase(ops, ref_fn, exact_fn) -> dict:
    """decode_attention against its plain version at the main paths' shapes
    (in bf16 also against the exact attention, exact_fn); its registers and
    spills; timed at gemma3-4b's and hymba-1.5b's, at the full cache and at
    two serving positions (hymba's offset by its meta tokens)."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    usage = ptxas_phase(ops, "decode_attention", "decode_attn_cluster_kernel", "kernel.ptxas")
    spills = max(u.get("spill_stores", 0) + u.get("spill_loads", 0) for u in usage)
    tight: dict = {"kernel": {}, "plain": {}}
    worst = max(k1_checks(ops, ref_fn, exact_fn, shape, gen, tight)
                for shape in (K1_GEMMA, K1_MOE, K1_HYMBA))
    phase("kernel.exact", tol=K1_BF16X_TOL, kernel=tight["kernel"], plain=tight["plain"])
    gemma = k1_times(ops, ref_fn, K1_GEMMA, {"serving": [200, 250],
                                             "profile": K1_PROFILE_POS}, gen)
    hymba = k1_times(ops, ref_fn, K1_HYMBA,
                     {"serving": [200 + HYMBA_META, 250 + HYMBA_META],
                      "profile": [p + HYMBA_META for p in K1_PROFILE_POS]}, gen)
    moe = k1_times(ops, ref_fn, K1_MOE, {"profile": K1_PROFILE_POS}, gen, full=False)
    return dict(gemma["full"], serving=gemma["serving"], profile=gemma["profile"],
                moe_profile=moe["profile"], hymba=hymba, max_abs_err=worst,
                bf16x=tight, ptxas_max_registers=max(u["registers"] for u in usage),
                ptxas_max_spill=spills)


def k1_times(ops, ref_fn, shape, positions: dict, gen, full: bool = True) -> dict:
    """K1's time at one shape, at the serving dtype (bf16) without softcap, at the
    full cache (pos = T-1, unless not ``full``) and at each labelled list of
    positions (the serving positions; the decode profiles' early ones): the
    kernel, the plain version, SDPA with GQA and the bound -> {label: row}."""
    b, t, h, kh, d = shape
    dtype = torch.bfloat16
    q = torch.randn(b, 1, h, d, generator=gen, device=DEVICE).to(dtype)
    k = torch.randn(b, t, kh, d, generator=gen, device=DEVICE).to(dtype)
    v = torch.randn(b, t, kh, d, generator=gen, device=DEVICE).to(dtype)
    out = {}
    for label, pos in (({"full": [t - 1] * b} if full else {}) | positions).items():
        p = torch.tensor(pos, dtype=torch.int32, device=DEVICE)
        mask = (torch.arange(t, device=DEVICE)[None, :] <= p[:, None].long())[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib_err = (library().transpose(1, 2).float() - ref_fn(q, k, v, p).float()).abs().max()
        if lib_err.item() > TOL[dtype]:
            raise AssertionError(f"SDPA disagrees with the plain version by {lib_err.item()}")
        keys = sum(min(x, t - 1) + 1 for x in pos)
        es = q.element_size()
        nbytes = keys * kh * d * 2 * es + 2 * q.numel() * es + p.numel() * 4
        nops = keys * h * d * 4                       # q.k and p.v, 2 flops per MAC
        bound_ms, bound_by = bound(nbytes, nops, dtype)
        row = dict(
            ms=time_ms(lambda: ops.decode_attention(q, k, v, p)),
            plain_ms=time_ms(lambda: ref_fn(q, k, v, p)),
            library_ms=time_ms(library), bound_ms=bound_ms, bound_by=bound_by)
        phase("kernel.time", shape=shape, pos=label, positions=pos, bytes=nbytes,
              n_split=ops.n_split(b * kh, t, h // kh, d, dtype, q.device),
              kernel_us=f"{row['ms'] * 1e3:.3f}", plain_us=f"{row['plain_ms'] * 1e3:.3f}",
              library_us=f"{row['library_ms'] * 1e3:.3f}",
              bound_us=f"{row['bound_ms'] * 1e3:.4f}", bound_by=row["bound_by"],
              launches_so_far=ops.launches)
        out[label] = row
    return out


def tight_reading(out, tight, tol, tag: str) -> dict:
    """A bf16 output against its design's own arithmetic: the largest share of
    tol = (atol, rtol) an element uses, and the norm of the error over the
    norm of the output."""
    out, tight = out.float(), tight.float()
    err = (out - tight).abs()
    atol, rtol = tol
    return {f"{tag}_max_abs_err": err.max().item(),
            f"{tag}_tol_share": (err / (atol + rtol * tight.abs())).max().item(),
            f"{tag}_norm_rel": (err.norm() / tight.norm().clamp_min(1e-30)).item()}


def bmm_chain(x, wg, wu, wo):
    """K3's function as a chain of cuBLAS calls (no single PyTorch op computes
    it): its library_ms, timed beside the kernel and used nowhere in the port."""
    h = torch.nn.functional.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)
    return torch.bmm(h, wo)


def k3_on_model_inputs(calls: list, ops) -> dict:
    """K3 and the bmm chain on the inputs the model gave its middle K3 call,
    with the card's clock and power under each."""
    k3 = [args for name, args, _, _ in calls if name == "moe_gemm"]
    x, wg, wu, wo = k3[len(k3) // 2]
    out = {}
    for label, fn in (("kernel", lambda: ops.moe_expert_ffn(x, wg, wu, wo)),
                      ("bmm_chain", lambda: bmm_chain(x, wg, wu, wo))):
        out[f"{label}_us"] = f"{time_ms(fn, iters=20) * 1e3:.3f}"
        out[f"{label}_sm_clock_power"] = loaded_clock(fn)
    return out


def moe_gemm_phase(ops, ref_fn, tight_fn) -> dict:
    """moe_expert_ffn against its plain version in each design, at the
    tolerance of tests/test_kernels.py::test_moe_gemm_sweep (_tol * 4), and
    each bf16 design against its own arithmetic (tight_fn) at K3_BF16H_TOL;
    timed at the deepseek-moe-16b decode call (dense and at 2 slots'
    occupancy) and prefill call in bf16."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)

    def inputs(e, c, d, f, dtype):
        # scaled as in tests/test_kernels.py: x * 0.5, weights / sqrt(fan-in)
        def draw(shape, scale):
            return (torch.randn(shape, generator=gen, device=DEVICE) * scale).to(dtype)
        return (draw((e, c, d), 0.5), draw((e, d, f), d ** -0.5), draw((e, d, f), d ** -0.5),
                draw((e, f, d), f ** -0.5))

    def designs(dtype, c):
        """Each design that takes this call."""
        if dtype == torch.float32:
            return ["fma"]
        return ["stream", "wgmma"] if c <= ops.STREAM_MAX_C else ["wgmma"]

    def hold(out, x, wg, wu, wo) -> dict:
        """out against the plain version at 4 * TOL and, in bf16, against the
        designs' arithmetic at K3_BF16H_TOL -> the readings."""
        tol = 4 * TOL[x.dtype]
        exp = ref_fn(x, wg, wu, wo).float()
        torch.testing.assert_close(out.float(), exp, atol=tol, rtol=tol)
        res = dict(max_abs_err=(out.float() - exp).abs().max().item(), tol=tol)
        if x.dtype == torch.bfloat16:
            atol, rtol = K3_BF16H_TOL
            tight = tight_fn(x, wg, wu, wo).float()
            res.update(tight_reading(out, tight, K3_BF16H_TOL, "bf16h"))
            torch.testing.assert_close(out.float(), tight, atol=atol, rtol=rtol)
            if res["bf16h_norm_rel"] > K3_BF16H_NORM:
                raise AssertionError(f"{tuple(x.shape)}: ||out - bf16h|| / ||bf16h|| = "
                                     f"{res['bf16h_norm_rel']}, bound {K3_BF16H_NORM}")
        return res

    worst, worst_share = 0.0, 0.0
    routes_run = set()
    for shape in K3_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, wg, wu, wo = inputs(*shape, dtype)
            x[:, 1::3] = 0.0                    # every third token row empty
            empty = [1, 2] if shape[0] > 3 else []
            if empty:                           # whole experts empty, as 0.0 and as -0.0
                x[1], x[2] = 0.0, -0.0
            for design in designs(dtype, shape[1]):
                out = ops._launch(design, x, wg, wu, wo)
                torch.cuda.synchronize()
                if not torch.isfinite(out).all():
                    raise AssertionError(f"{shape} {dtype} {design}: non-finite kernel output")
                zero_rows_nonzero = torch.count_nonzero(out[:, 1::3]).item()
                empty_nonzero = torch.count_nonzero(out[empty]).item() if empty else 0
                if zero_rows_nonzero or empty_nonzero:
                    raise AssertionError(f"{shape} {design}: zero rows gave {zero_rows_nonzero} "
                                         f"and empty experts {empty_nonzero} nonzero outputs")
                res = hold(out, x, wg, wu, wo)
                worst = max(worst, res["max_abs_err"])
                worst_share = max(worst_share, res.get("bf16h_tol_share", 0.0))
                routes_run.add(design)
                phase("kernel.moe_gemm.check", shape=shape, dtype=str(dtype).split(".")[1],
                      route=design, default_route=ops.route(dtype, shape[1]) == design,
                      **{k: f"{v:.3g}" for k, v in res.items()}, zero_rows_exact=True,
                      empty_experts_exact=bool(empty))
                del out
            del x, wg, wu, wo
            free_cuda()
    if routes_run != {"fma", "stream", "wgmma"}:
        raise AssertionError(f"the checks ran only {routes_run}")
    # a single token in an otherwise empty expert is computed, not skipped
    x, wg, wu, wo = inputs(*K3_DECODE, torch.bfloat16)
    x.zero_()
    x[5, 3] = torch.randn(x.shape[2], generator=gen, device=DEVICE).to(x.dtype) * 0.5
    for design in designs(x.dtype, x.shape[1]):
        out = ops._launch(design, x, wg, wu, wo)
        torch.cuda.synchronize()
        res = hold(out, x, wg, wu, wo)
        if not torch.count_nonzero(out[5, 3]) or torch.count_nonzero(out) != torch.count_nonzero(
                out[5, 3]):
            raise AssertionError(f"{design}: a lone token was skipped, or zeros came out nonzero")
        phase("kernel.moe_gemm.check", shape=K3_DECODE, dtype="bfloat16", route=design,
              lone_token_computed=True, **{k: f"{v:.3g}" for k, v in res.items()})
        del out
    del x, wg, wu, wo
    free_cuda()

    dtype = torch.bfloat16
    es = 2
    rows = {}
    for label, shape in (("decode", K3_DECODE), ("occupied", K3_DECODE),
                         ("prefill", K3_PREFILL)):
        e, c, d, f = shape
        x, wg, wu, wo = inputs(e, c, d, f, dtype)
        occupied = e
        if label == "occupied":                 # 12 experts holding one token each
            x.zero_()
            picked = torch.randperm(e, generator=gen, device=DEVICE)[:K3_OCCUPIED]
            x[picked, 0] = (torch.randn(K3_OCCUPIED, d, generator=gen, device=DEVICE)
                            * 0.5).to(dtype)
            occupied = K3_OCCUPIED

        def library():
            return bmm_chain(x, wg, wu, wo)
        lib_err = (library().float() - ref_fn(x, wg, wu, wo).float()).abs().max().item()
        if lib_err > 4 * TOL[dtype]:
            raise AssertionError(f"the bmm chain disagrees with the plain version by {lib_err}")
        # this call's data: the weights of the occupied experts, x read and out written once;
        # the products of its nonzero token rows
        tokens = int(x.ne(0).any(-1).sum()) if label == "occupied" else e * c
        nbytes = (3 * occupied * d * f + 2 * e * c * d) * es
        nops = 6 * tokens * d * f
        bound_ms, bound_by = bound(nbytes, nops, dtype)
        row = dict(ms=time_ms(lambda: ops.moe_expert_ffn(x, wg, wu, wo)),
                   plain_ms=time_ms(lambda: ref_fn(x, wg, wu, wo), iters=20),
                   library_ms=time_ms(library), bound_ms=bound_ms, bound_by=bound_by,
                   max_abs_err=worst)
        phase("kernel.moe_gemm.time", call=label, shape=shape, dtype="bfloat16",
              route=ops.route(dtype, c), occupied_experts=occupied, bytes=nbytes, ops=nops,
              kernel_us=f"{row['ms'] * 1e3:.3f}", plain_us=f"{row['plain_ms'] * 1e3:.3f}",
              library_bmm_chain_us=f"{row['library_ms'] * 1e3:.3f}",
              bound_us=f"{row['bound_ms'] * 1e3:.4f}", bound_by=bound_by,
              bound_share=f"{row['bound_ms'] / row['ms']:.4f}",
              kernel_tflop_s=f"{nops / row['ms'] / 1e9:.1f}",
              kernel_gb_s=f"{nbytes / row['ms'] / 1e6:.1f}",
              kernel_sm_clock_power=repr(loaded_clock(lambda: ops.moe_expert_ffn(x, wg, wu, wo))),
              bmm_chain_sm_clock_power=repr(loaded_clock(library)))
        rows[label] = row
        del x, wg, wu, wo
        free_cuda()

    return dict(rows["decode"], occupied_call=rows["occupied"], prefill_call=rows["prefill"],
                bf16h_tol_share=worst_share)


def fa_work(shape, es: int) -> tuple[int, int]:
    """(bytes, flops) of one flash-attention call: q, k, v read once and out
    written once; 4 D flops (q . k and p . v) per visible (query, key) pair
    and query head, counted from this call's masks."""
    b, s, t, h, kh, d, causal, window, _, q_offset = shape
    qpos = np.arange(s) + q_offset
    hi = np.minimum(t, qpos + 1) if causal else np.full(s, t)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(s, np.int64)
    pairs = int(np.maximum(hi - lo, 0).sum())
    return (2 * b * s * h * d + 2 * b * t * kh * d) * es, 4 * d * pairs * b * h


@dataclasses.dataclass
class KernelStat:
    """One device activity's launches in a profile, by name: the fields of the
    profiler's key_averages() rows that the phases read (times in us)."""
    key: str
    count: int = 0
    self_device_time_total: float = 0.0


def device_kernels(fn, reps: int = 1, ranges: dict | None = None):
    """Run fn reps times under the profiler -> (host wall s per rep, the
    device activities (kernels, copies, fills) by name as KernelStat, and
    each one's (name, start, end) on the device in us; both empty if it saw
    none).  They are read from the profiler's raw events: its per-event
    parse (``events()``, ``key_averages()``) took 139 s after a hymba
    prefill of 135k one-token launches.  ``ranges`` maps the names of
    record_function ranges that fn opens to dicts, filled per rep with the
    range's calls, its host time, and its device time: the union of the
    activities inside the device-side spans the profiler gives the range
    (from the first to the last activity launched in it; one stream, so
    nothing else runs there), in us."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) / reps
    raw = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in raw if e.device_type() == cuda]
    base = min((e.start_ns() for e in dev), default=0)

    def us(e):
        return e.name(), (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3
    # a range's own device-side span is no activity
    spans = [us(e) for e in dev if not e.is_user_annotation()]
    kern: dict = {}
    for name, start, end in spans:
        stat = kern.setdefault(name, KernelStat(name))
        stat.count += 1
        stat.self_device_time_total += end - start
    for name, out in (ranges or {}).items():
        host = [e.duration_ns() for e in raw if e.name() == name and e.is_user_annotation()
                and e.device_type() != cuda]
        windows = sorted(us(e)[1:] for e in dev if e.name() == name and e.is_user_annotation())
        starts = [w[0] for w in windows]
        inside = []
        for _, start, end in spans:
            i = bisect.bisect_right(starts, start) - 1
            if i >= 0 and start < windows[i][1]:
                inside.append((start, min(end, windows[i][1])))
        out.update(calls=len(host) / reps, host_us=sum(host) / 1e3 / reps,
                   device_us=covered_us(inside) / reps)
    return wall, list(kern.values()), spans


def covered_us(spans) -> float:
    """Length of the union of (start, end) intervals: kernels launched as
    programmatic dependents (K3's second and third) start before the one
    before them ends, so a sum of kernel times would count the overlap twice."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def k2_designs(ops, dtype, d: int) -> list:
    """Each K2 design that takes a call of this type and head dim."""
    if dtype == torch.float32:
        return ["fma"]
    return ["mma", "wgmma"] if d in ops.WGMMA_HEAD_DIMS else ["mma"]


def k2_host_us(ops, reps: int = 200) -> dict:
    """Host time to enqueue one call of each bf16 design at a shape whose
    device time is short (so the queue never backs up): the wgmma design
    encodes its three tensor maps on the host at every call."""
    q, k, v = (torch.randn(dims, device=DEVICE).to(torch.bfloat16)
               for dims in ((1, 128, 1, 256), (1, 128, 1, 256), (1, 128, 1, 256)))
    out: dict = {"mma": [], "wgmma": []}
    for design in ("mma", "wgmma", "wgmma", "mma"):
        for _ in range(20):
            ops._launch(design, q, k, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            ops._launch(design, q, k, v)
        out[design].append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return {d: round(statistics.mean(x), 3) for d, x in out.items()}


def flash_attention_phase(ops, ref_fn, tight_fn, visible, build) -> dict:
    """flash_attention against its plain version over K2_SHAPES in every design
    that takes each shape (float32: fma; bf16: mma and, at D 64, 128 and 256,
    wgmma), each bf16 design also against its own arithmetic (tight_fn at the
    design's key tile) at K2_BF16P_TOL and K2_BF16_NORM; rows that see no key
    come out 0 in every design; the wgmma kernels' registers and spills, none
    allowed; timed at gemma3-4b's global and local, deepseek-moe-16b's and
    hymba-1.5b's global and local prefill shapes (bf16), both bf16 designs in
    turns (mma, wgmma, wgmma, mma), against the plain version, SDPA and the
    bound; the host time of a call in each bf16 design."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    log = build.library_path("flash_attention", ops.SOURCES).with_suffix(".log").read_text()
    usage = ptxas_usage(log, "fa_fwd_wgmma_kernel")
    for u in usage:
        d = u.pop("kernel").split("ILi")[1].split("E")[0]
        phase("kernel.flash_attention.ptxas", kernel=f"fa_fwd_wgmma_kernel<{d}>", **u)
        if u["spill_stores"] or u["spill_loads"]:
            raise AssertionError(f"fa_fwd_wgmma_kernel<{d}> spills: {u}")
    if len(usage) != len(ops.WGMMA_HEAD_DIMS):
        raise AssertionError(f"the build log names {len(usage)} wgmma kernels")

    def inputs(shape, dtype):
        b, s, t, h, kh, d = shape[:6]
        return (torch.randn(dims, generator=gen, device=DEVICE).to(dtype)
                for dims in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))

    def kw(shape):
        causal, window, softcap, q_offset = shape[6:]
        return dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)

    worst = 0.0
    holds: dict = {}                            # per bf16 design: its worst tight readings
    for shape in K2_SHAPES:
        d = shape[5]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = inputs(shape, dtype)
            exp = ref_fn(q, k, v, **kw(shape)).float()
            for design in k2_designs(ops, dtype, d):
                out = ops._launch(design, q, k, v, **kw(shape))
                torch.cuda.synchronize()
                if not torch.isfinite(out).all():
                    raise AssertionError(f"non-finite kernel output {shape} {dtype} {design}")
                res = dict(max_abs_err=(out.float() - exp).abs().max().item(), tol=TOL[dtype])
                tight = None
                if dtype == torch.bfloat16:
                    tight = tight_fn(q, k, v, block_k=ops.block_k(design, d), **kw(shape))
                    res.update(tight_reading(out, tight, K2_BF16P_TOL, "bf16p"))
                    # the plain version (P in fp32), which the tight hold must part from
                    res["plain_bf16p_norm_rel"] = tight_reading(exp, tight, K2_BF16P_TOL,
                                                                "bf16p")["bf16p_norm_rel"]
                    mine = holds.setdefault(design, {})
                    for key in ("bf16p_max_abs_err", "bf16p_tol_share", "bf16p_norm_rel"):
                        mine[key] = max(mine.get(key, 0.0), res[key])
                phase("kernel.flash_attention.check", shape=shape,
                      dtype=str(dtype).split(".")[1], design=design,
                      default_route=ops.route(dtype, d) == design,
                      **{key: f"{x:.3g}" for key, x in res.items()})
                torch.testing.assert_close(out.float(), exp, atol=TOL[dtype], rtol=TOL[dtype])
                if tight is not None:
                    torch.testing.assert_close(out.float(), tight.float(), atol=K2_BF16P_TOL[0],
                                               rtol=K2_BF16P_TOL[1])
                    if res["bf16p_norm_rel"] > K2_BF16_NORM:
                        raise AssertionError(f"{shape} {design}: ||out - bf16p|| / ||bf16p|| = "
                                             f"{res['bf16p_norm_rel']}, bound {K2_BF16_NORM}")
                worst = max(worst, res["max_abs_err"])
                del out, tight
            del q, k, v, exp
            free_cuda()
    # S 96 against T 32, window 16: row i sees keys (i - 16, i], none once i >= 47
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 64), (torch.bfloat16, 256)):
        q, k, v = inputs((1, 96, 32, 4, 2, d), dtype)
        for design in k2_designs(ops, dtype, d):
            out = ops._launch(design, q, k, v, causal=True, window=16)
            torch.cuda.synchronize()
            if torch.count_nonzero(out[:, 47:]) or not torch.count_nonzero(out[:, :47]):
                raise AssertionError(f"{design} D {d}: rows that see no key are not 0")
            torch.testing.assert_close(out.float(), ref_fn(q, k, v, window=16).float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])
            phase("kernel.flash_attention.zero_rows", dtype=str(dtype).split(".")[1], d=d,
                  design=design, rows_47_to_95_zero=True)

    dtype = torch.bfloat16
    rows = {}
    for label, shape in (("global", K2_GLOBAL), ("local", K2_LOCAL), ("moe", K2_MOE),
                         ("hymba_global", K2_HYMBA_GLOBAL), ("hymba_local", K2_HYMBA_LOCAL)):
        b, s, t, h, kh, d, _, window = shape[:8]
        q, k, v = inputs(shape, dtype)
        # SDPA on its own (B, H, S, D) layout; the local layer's window as a
        # boolean mask, which rules out the flash backend
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if window is None:
            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            mask = visible(s, t, causal=True, window=window, q_offset=0, device=DEVICE)

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
        exp = ref_fn(q, k, v, **kw(shape))
        lib_err = (library().transpose(1, 2).float() - exp.float()).abs().max().item()
        if lib_err > TOL[dtype]:
            raise AssertionError(f"SDPA disagrees with the plain version by {lib_err}")
        del exp
        _, kern, _ = device_kernels(library)
        backend = sorted({e.key[:60] for e in kern})
        nbytes, nops = fa_work(shape, q.element_size())
        bound_ms, bound_by = bound(nbytes, nops, dtype)
        turns: dict = {"mma": [], "wgmma": []}
        for design in ("mma", "wgmma", "wgmma", "mma"):
            turns[design].append(time_ms(lambda: ops._launch(design, q, k, v, **kw(shape)),
                                         iters=20))
        row = dict(ms=statistics.mean(turns["wgmma"]), mma_ms=statistics.mean(turns["mma"]),
                   plain_ms=time_ms(lambda: ref_fn(q, k, v, **kw(shape)), iters=5),
                   library_ms=time_ms(library, iters=20), bound_ms=bound_ms,
                   bound_by=bound_by, max_abs_err=worst)
        phase("kernel.flash_attention.time", layer=label, shape=shape, dtype="bfloat16",
              bytes=nbytes, ops=nops, route=ops.route(dtype, d),
              wgmma_us=[f"{x * 1e3:.3f}" for x in turns["wgmma"]],
              mma_us=[f"{x * 1e3:.3f}" for x in turns["mma"]],
              plain_us=f"{row['plain_ms'] * 1e3:.3f}",
              library_sdpa_us=f"{row['library_ms'] * 1e3:.3f}", sdpa_kernels=repr(backend),
              bound_us=f"{row['bound_ms'] * 1e3:.4f}", bound_by=bound_by,
              bound_share=f"{row['bound_ms'] / row['ms']:.4f}",
              achieved_tflops=f"{nops / row['ms'] / 1e9:.2f}",
              wgmma_sm_clock_power=repr(loaded_clock(
                  lambda: ops._launch("wgmma", q, k, v, **kw(shape)), n=100)))
        rows[label] = row
        del q, k, v, qt, kt, vt
        free_cuda()
    host = k2_host_us(ops)
    phase("kernel.flash_attention.host", host_us_per_call=host,
          map_encoding_us=f"{host['wgmma'] - host['mma']:.3f}")
    return dict(rows["global"], local_layer=rows["local"], moe_layer=rows["moe"],
                hymba_global_layer=rows["hymba_global"], hymba_local_layer=rows["hymba_local"],
                bf16p_holds=holds, host_us_per_call=host)


def k4_inputs(shape, dtype, gen, hard=False):
    """r, k, v in dtype, logw and u float32, scaled as in tests/test_kernels.py:
    r, v ~ N(0, 1), k * 0.3, logw = -exp(N * 0.5 - 1) clipped to [1e-4, 8],
    u * 0.2; hard: logw = -8 everywhere, k unscaled, u = 0."""
    b, t, h, d = shape

    def n(*dims):
        return torch.randn(dims, generator=gen, device=DEVICE)
    r, k, v = n(b, t, h, d), n(b, t, h, d) * (1.0 if hard else 0.3), n(b, t, h, d)
    lw = (torch.full((b, t, h, d), -8.0, device=DEVICE) if hard
          else -torch.exp(n(b, t, h, d) * 0.5 - 1.0).clamp(1e-4, 8.0))
    u = torch.zeros((h, d), device=DEVICE) if hard else n(h, d) * 0.2
    return r.to(dtype), k.to(dtype), v.to(dtype), lw, u


def rwkv6_scan_work(shape, es: int, with_state: bool) -> tuple[int, int]:
    """(bytes, flops) of one wkv-scan call: r, k, v (es bytes each), logw, u and,
    with_state, s0 read once, y and S written once; per (16-token chunk, head)
    the scores and intra products (4 C^2 D) and the cross and state products
    (4 C D^2)."""
    b, t, h, d = shape
    c = 16
    n = b * t * h * d
    state = 4 * b * h * d * d
    nbytes = 3 * n * es + 4 * n + 4 * h * d + (state if with_state else 0) + state + 4 * n
    return nbytes, -(-t // c) * b * h * (4 * c * c * d + 4 * c * d * d)


def stage_us(fn, names, reps: int = 20) -> dict:
    """Median device time (us) of each kernel whose name holds one of ``names``,
    over reps calls of fn under the profiler, the L2 flushed before each."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for name in names:
        times = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == cuda and name in e.name]
        out[name] = round(statistics.median(times), 3) if times else None
    return out


def rwkv6_scan_phase(ops, ref_fn) -> dict:
    """rwkv6_scan against its plain version over K4_SHAPES in f32 and bf16, from
    a non-zero state at K4_STATE, and at the hard decay; its kernels' registers
    and spills; timed per call and per pass at rwkv6-3b's prefill call as
    layer_prefill makes it (bf16 r, k, v; the cache's zeroed state as s0)."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    usage = ptxas_phase(ops, "rwkv6_scan", "rwkv6_seg_", "kernel.rwkv6_scan.ptxas")
    cases = [(shape, dtype, False, False) for shape in K4_SHAPES
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(shape, torch.bfloat16, True, False) for shape in K4_STATE]
    cases += [(K4_HARD, dtype, False, True) for dtype in (torch.float32, torch.bfloat16)]
    worst = 0.0
    for shape, dtype, with_state, hard in cases:
        r, k, v, lw, u = k4_inputs(shape, dtype, gen, hard=hard)
        b, _, h, d = shape
        s0 = torch.randn((b, h, d, d), generator=gen, device=DEVICE) if with_state else None
        y, s = ops.rwkv6_scan(r, k, v, lw, u, s0)
        torch.cuda.synchronize()
        ey, es = ref_fn(r, k, v, lw, u, s0)
        if not (torch.isfinite(y).all() and torch.isfinite(s).all()):
            raise AssertionError(f"non-finite kernel output {shape} {dtype} hard={hard}")
        atol, rtol = K4_HARD_TOL if hard else K4_TOL
        err = max((y - ey).abs().max().item(), (s - es).abs().max().item())
        torch.testing.assert_close(y, ey, atol=atol, rtol=rtol)
        torch.testing.assert_close(s, es, atol=atol, rtol=rtol)
        worst = max(worst, err)
        phase("kernel.rwkv6_scan.check", shape=shape, dtype=str(dtype).split(".")[1],
              input_state=with_state, hard_decay=hard, max_abs_err=f"{err:.3g}",
              tol=(atol, rtol), max_abs_y=f"{ey.abs().max().item():.4g}")
        del r, k, v, lw, u, s0, y, s, ey, es
        free_cuda()

    dtype = torch.bfloat16
    r, k, v, lw, u = k4_inputs(K4_MODEL, dtype, gen)
    b, _, h, d = K4_MODEL
    s0 = torch.zeros((b, h, d, d), device=DEVICE)
    nbytes, nops = rwkv6_scan_work(K4_MODEL, r.element_size(), with_state=True)
    bound_ms, bound_by = bound(nbytes, nops, dtype)
    row = dict(ms=time_ms(lambda: ops.rwkv6_scan(r, k, v, lw, u, s0), iters=20),
               plain_ms=time_ms(lambda: ref_fn(r, k, v, lw, u, s0), iters=5),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst,
               segment=ops.SEGMENT,
               stage_us=stage_us(lambda: ops.rwkv6_scan(r, k, v, lw, u, s0),
                                 KERNEL_NAMES["rwkv6_scan"]),
               ptxas_max_registers=max(x["registers"] for x in usage),
               ptxas_max_spill=max(x.get("spill_stores", 0) + x.get("spill_loads", 0)
                                   for x in usage))
    phase("kernel.rwkv6_scan.time", shape=K4_MODEL, dtype="bfloat16", bytes=nbytes, ops=nops,
          segment=ops.SEGMENT, stage_us=row["stage_us"],
          kernel_us=f"{row['ms'] * 1e3:.3f}", plain_us=f"{row['plain_ms'] * 1e3:.3f}",
          library="none (no single PyTorch call computes the wkv recurrence)",
          bound_us=f"{row['bound_ms'] * 1e3:.4f}", bound_by=bound_by,
          bound_share=f"{row['bound_ms'] / row['ms']:.4f}",
          achieved_gb_per_s=f"{nbytes / row['ms'] / 1e6:.1f}",
          fp32_fma_floor_us=f"{nops / PEAK_OPS[torch.float32] * 1e6:.3f}")
    del r, k, v, lw, u, s0
    free_cuda()
    return row


def per_step_launches(cfg, stack) -> dict:
    """Kernel launches one decode step makes: K1 on every full-cache MHA/GQA
    layer (hymba's 3 among them; MLA, the ssm family and whisper make none), K3
    once on every moe layer (one dispatch group); rwkv6's one-token decode and
    hymba's Mamba branch are plain torch."""
    attn = cfg.family not in ("ssm", "encdec") and not cfg.use_mla
    return {"decode_attention": sum(w is None for w in stack.layer_windows(cfg)) if attn else 0,
            "flash_attention": 0,
            "moe_gemm": sum(k == "moe" for k in stack.layer_kinds(cfg)),
            "rwkv6_scan": 0}


def per_prefill_launches(cfg, stack, moe, tokens: int) -> dict:
    """Kernel launches one prefill (or forward) of ``tokens`` tokens makes: K2
    on every MHA/GQA layer, local and global (hymba's 32 among them; MLA's and
    whisper's attention is plain torch), K3 once per dispatch group on every
    moe layer, K4 once on every rwkv6 layer."""
    groups = tokens // min(moe.MOE_GROUP, tokens)
    ssm = cfg.family == "ssm"
    plain_attn = cfg.use_mla or ssm or cfg.family == "encdec"
    return {"decode_attention": 0,
            "flash_attention": 0 if plain_attn else cfg.num_layers,
            "moe_gemm": groups * sum(k == "moe" for k in stack.layer_kinds(cfg)),
            "rwkv6_scan": cfg.num_layers if ssm else 0}


KERNEL_NAMES = {"decode_attention": ("decode_attn_cluster_kernel",),
                "flash_attention": ("fa_fwd_",),
                # moe_up_{fma,stream,wgmma}_kernel runs once a call in every design; then
                # moe_down_{fma,stream,wgmma}_kernel and the stream's moe_occupancy_kernel
                "moe_gemm": ("moe_up_", "moe_down_", "moe_occupancy_"),
                # the output pass runs once a call; the local-state and boundary passes when
                # T exceeds a segment
                "rwkv6_scan": ("rwkv6_seg_out_kernel", "rwkv6_seg_local_kernel",
                               "rwkv6_seg_pass_kernel")}


def kernel_summary(kern, spans, reps: int) -> dict:
    """Device busy time per rep (ms, the union of kernel intervals), each of
    our kernels' calls and device time per call (us, the union of its
    launches' intervals), and the five kernels that took the most time, from
    profiler events."""
    busy = covered_us((s, e) for _, s, e in spans) / reps / 1e3
    out = dict(device_busy_ms=busy, kernels=sum(e.count for e in kern) / reps)
    for name, keys in KERNEL_NAMES.items():
        calls = sum(e.count for e in kern if keys[0] in e.key)
        us = covered_us((s, e) for n, s, e in spans if any(k in n for k in keys))
        out[name] = dict(calls=calls, us_per_call=round(us / max(calls, 1), 2),
                         ms_per_rep=round(us / reps / 1e3, 3))
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    out["top"] = "; ".join(f"{e.key[:48]} {e.self_device_time_total / reps / 1e3:.3f}ms "
                           f"x{e.count / reps:.0f}" for e in top)
    return out


def profile_steps(rep, name: str, steps: int = 10) -> None:
    """Where a warm decode step's time goes: the device's busy time (the
    union of kernel intervals) against the host's wall time.  The profiler
    adds host overhead, so this wall time is above an unprofiled step's."""
    steps_done = iter(range(steps))
    wall, kern, spans = device_kernels(lambda: rep.step(float(next(steps_done))), steps)
    if not kern:
        phase("model.profile", arch=name,
              device_busy="not measured (the profiler saw no kernels)")
        return
    summ = kernel_summary(kern, spans, steps)
    busy = summ["device_busy_ms"] / 1e3
    phase("model.profile", arch=name, steps=steps, wall_ms_per_step=f"{wall * 1e3:.3f}",
          device_busy_ms_per_step=f"{busy * 1e3:.3f}", idle_share=f"{1 - busy / wall:.4f}",
          kernels_per_step=f"{summ['kernels']:.1f}",
          decode_attention=summ["decode_attention"], moe_gemm=summ["moe_gemm"],
          top=repr(summ["top"]))


def kernel_sites() -> list:
    """(module, attribute, kernel) of every kernel call the models make."""
    from repro_torch.models import attention, moe, rwkv6
    return [(attention, "decode_attention", "decode_attention"),
            (attention, "flash_attention", "flash_attention"),
            (moe, "moe_expert_ffn", "moe_gemm"),
            (rwkv6, "rwkv6_scan", "rwkv6_scan")]


@contextlib.contextmanager
def swapped_kernels(make):
    """Each kernel call of the models replaced by make(kernel, wrapper)."""
    sites = kernel_sites()
    saved = [getattr(mod, attr) for mod, attr, _ in sites]
    for (mod, attr, name), fn in zip(sites, saved):
        setattr(mod, attr, make(name, fn))
    try:
        yield
    finally:
        for (mod, attr, _), fn in zip(sites, saved):
            setattr(mod, attr, fn)


def plain_kernels(plain: dict):
    """The model's kernel calls swapped for their plain torch versions: the
    same fp32 arithmetic on the same device, with no launch."""
    return swapped_kernels(lambda name, fn: plain[name])


def recorded_calls(into: list):
    """Record every kernel call the model makes: (kernel, args, kwargs, output).
    K4's input state is the cache's, which the model overwrites in place after
    the call, so it is recorded as a copy."""
    def recording(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if name == "rwkv6_scan" and len(args) > 5 and args[5] is not None:
                args = (*args[:5], args[5].clone(), *args[6:])
            into.append((name, args, kw, out))
            return out
        return call
    return swapped_kernels(recording)


def call_tol(name: str, dtype) -> tuple[float, float]:
    """(atol, rtol) of a kernel against its plain version: the kernel phases'."""
    if name == "rwkv6_scan":
        return K4_TOL
    tol = TOL[dtype] * (4 if name == "moe_gemm" else 1)
    return tol, tol


def hold_calls(calls: list, plain: dict) -> dict:
    """Each recorded kernel call against its plain version on the very inputs
    the model gave it, at the kernel phases' tolerances -> worst error per kernel.
    A bf16 K3 call is also held to its designs' arithmetic (plain["moe_gemm_bf16h"])
    within K3_BF16H_NORM over the whole output; the share of K3_BF16H_TOL its
    worst element uses is reported."""
    err: dict = {}
    for name, args, kw, out in calls:
        exp = plain[name](*args, **kw)
        pairs = zip(out, exp) if isinstance(out, tuple) else [(out, exp)]
        for o, e in pairs:
            atol, rtol = call_tol(name, o.dtype)
            torch.testing.assert_close(o.float(), e.float(), atol=atol, rtol=rtol)
            err[name] = max(err.get(name, 0.0), (o.float() - e.float()).abs().max().item())
        del exp, pairs
        if name == "flash_attention" and out.dtype == torch.bfloat16:
            for key, v in tight_reading(out, plain["flash_attention_bf16p"](*args, **kw),
                                        K2_BF16P_TOL, "bf16p").items():
                err[f"flash_attention_{key}"] = max(err.get(f"flash_attention_{key}", 0.0), v)
            if err["flash_attention_bf16p_norm_rel"] > K2_BF16_NORM:
                raise AssertionError(f"a K2 call on the model's inputs: ||out - bf16p|| / "
                                     f"||bf16p|| = {err['flash_attention_bf16p_norm_rel']}, "
                                     f"bound {K2_BF16_NORM}")
        if name == "moe_gemm" and out.dtype == torch.bfloat16:
            for key, v in tight_reading(out, plain["moe_gemm_bf16h"](*args, **kw),
                                        K3_BF16H_TOL, "bf16h").items():
                err[f"moe_gemm_{key}"] = max(err.get(f"moe_gemm_{key}", 0.0), v)
            if err["moe_gemm_bf16h_norm_rel"] > K3_BF16H_NORM:
                raise AssertionError(f"a K3 call on the model's inputs: ||out - bf16h|| / "
                                     f"||bf16h|| = {err['moe_gemm_bf16h_norm_rel']}, bound "
                                     f"{K3_BF16H_NORM}")
    return err


@contextlib.contextmanager
def recorded_routes(moe, into: list):
    """Record each moe layer's expert picks (sorted ids per token)."""
    route = moe._route

    def recording(cfg, p, xg):
        out = route(cfg, p, xg)
        into.append(out[1].sort(-1).values)
        return out
    moe._route = recording
    try:
        yield
    finally:
        moe._route = route


def model_phase(cfg, n_params: int, n_bytes: int, kernels: dict, plain: dict, registry,
                stack, ModelReplica, ServeRequest) -> dict:
    """One full-width replica: counts, cold start, timed steps with their
    kernel launches, a profiled step, and one step checked: every kernel call
    in it against its plain version on the inputs the model gave it, and its
    logits against the model with plain versions in the kernels' place and
    against ``attn_impl="ref"``.  Returns the launches of the timed steps."""
    from repro_torch.models import moe
    got = registry.param_count(cfg)
    if got != n_params:
        raise AssertionError(f"{cfg.name} has {got} parameters, expected {n_params}")
    rep = ModelReplica(cfg, max_slots=MAX_SLOTS, max_seq=MAX_SEQ, seed=0, device=DEVICE)
    if rep.memory_bytes() != n_bytes:
        raise AssertionError(f"{cfg.name} replica holds {rep.memory_bytes()} B, "
                             f"expected {n_bytes}")
    rng = np.random.default_rng(1)
    for i in range(MAX_SLOTS):
        prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
        rep.add(ServeRequest(rid=i, fn=0, prompt=prompt, max_new_tokens=1), 0.0)
    per_step = per_step_launches(cfg, stack)
    for ops in kernels.values():
        ops.launches = 0                       # count only the timed steps' launches
    step_s = []
    for s in range(40):
        t0 = time.monotonic()
        rep.step(float(s))                      # ends in the step's host sync
        step_s.append(time.monotonic() - t0)
    launches = {name: ops.launches for name, ops in kernels.items()}
    for name, n in launches.items():
        if n != per_step[name] * len(step_s):
            raise AssertionError(f"{name} launched {n} times in {len(step_s)} decode steps "
                                 f"of {cfg.name}; expected {per_step[name]} per step")
    profile_steps(rep, cfg.name)
    # one step on the same weights and cache, three ways: the kernels (every
    # call recorded); their plain versions in their place; the plain torch
    # model (attn_impl="ref")
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (MAX_SLOTS, 1)), dtype=torch.int32,
                        device=DEVICE)
    pos = torch.tensor(rep._pos, device=DEVICE)
    logits, routes, calls = {}, {}, []
    for label, impl in (("kernel", "kernel"), ("plain", "kernel"), ("ref", "ref")):
        cache = [{n: t.clone() for n, t in layer.items()} for layer in rep.cache]
        routes[label] = []
        swap = (plain_kernels(plain) if label == "plain"
                else recorded_calls(calls) if label == "kernel"
                else contextlib.nullcontext())
        with swap, recorded_routes(moe, routes[label]):
            lg, _ = registry.decode_step(cfg.replace(attn_impl=impl), rep.params, cache,
                                         toks, pos)
        logits[label] = lg.float()
        del cache
    if not torch.isfinite(logits["kernel"]).all():
        raise AssertionError("non-finite logits")
    if logits["kernel"].shape != (MAX_SLOTS, 1, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(logits['kernel'].shape)}")
    # each kernel call of the step against its plain version on the very
    # inputs the model gave it, at the kernel phases' tolerances
    call_err = hold_calls(calls, plain)
    n_calls = {name: sum(c[0] == name for c in calls) for name in kernels}
    if n_calls != per_step:
        raise AssertionError(f"one step of {cfg.name} made kernel calls {n_calls}, "
                             f"expected {per_step}")
    del calls

    def rel_err(other):
        return ((logits["kernel"] - logits[other]).abs().max()
                / logits[other].abs().max()).item()

    def flips(other):     # tokens whose expert set differs, over all moe layers
        return sum(int((a != b).any(-1).sum()) for a, b in zip(routes["kernel"], routes[other]))
    rel, rel_ref = rel_err("plain"), rel_err("ref")
    # Held on the dense arch only.  On a deep moe model with random weights a
    # one-ulp bf16 difference in one layer's output grows through the later
    # layers and can flip near-tied top-k picks, so whole-step logits are
    # reported there, and the kernels are held call by call above.
    if not per_step["moe_gemm"] and max(rel, rel_ref) > 2e-2:
        raise AssertionError(f"kernel logits differ from the plain versions' by {rel} and "
                             f"from attn_impl=ref by {rel_ref} (relative)")
    phase("model", arch=cfg.name, params=got, layers=cfg.num_layers,
          launches_per_step=per_step, memory_bytes=rep.memory_bytes(),
          cold_start_s=f"{rep.cold_start_s:.4f}",
          decode_step_ms_median=f"{statistics.median(step_s[5:]) * 1e3:.3f}",
          decode_step_ms_min=f"{min(step_s[5:]) * 1e3:.3f}", launches=launches,
          pos=rep._pos.tolist(), step_kernel_calls=n_calls,
          step_calls_max_abs_err_vs_plain={k: f"{v:.3g}" for k, v in call_err.items()},
          logits_rel_err_kernel_vs_plain=f"{rel:.3g}",
          routing_flips_kernel_vs_plain=flips("plain"),
          logits_rel_err_kernel_vs_ref=f"{rel_ref:.3g}",
          routing_flips_kernel_vs_ref=flips("ref"),
          moe_tokens_routed=sum(int(r.shape[0] * r.shape[1]) for r in routes["kernel"]))
    del rep, logits
    free_cuda()
    return launches


def serve_phase(cfg, kernels: dict, stack, ControlPlane, TorchWorkerBackend, make_policy,
                ServeRequest, *, n_requests: int, prompt_lens: tuple[int, int],
                max_new_tokens: int, max_replicas: int) -> dict:
    """Serve n_requests through ControlPlane; the launches of each kernel must
    be its launches per step x the decode steps taken.  Counts slot reuses
    (a request placed in a slot an earlier request used) and, on the families
    with a recurrent state (ssm: every cache tensor; hybrid: ssm_h and conv),
    requires some and checks that each leaves the slot's state all zero before
    the request's first step."""
    from repro_torch.models import registry
    torch.cuda.reset_peak_memory_stats()
    placed: list = []
    reset = registry.reset_slot
    recurrent = RECURRENT.get(cfg.family)

    def checked_reset(cfg_, cache, slot):
        reset(cfg_, cache, slot)
        placed.append((id(cache), slot))
        if recurrent and torch.stack(
                [t[slot].abs().max().float() for layer in cache for name, t in layer.items()
                 if recurrent == "all" or name in recurrent]).max().item() != 0:
            raise AssertionError(f"slot {slot} holds a non-zero state after its reset")
    backend = TorchWorkerBackend(cfg, max_slots=MAX_SLOTS, max_seq=MAX_SEQ, device=DEVICE)
    cp = ControlPlane(backend, lambda f: make_policy("sync", keepalive_s=30.0,
                                                      container_concurrency=MAX_SLOTS),
                      num_functions=2, fleet=ReplicaCap(max_replicas))
    rng = np.random.default_rng(0)
    arrivals = np.sort(rng.uniform(0, 4.0, n_requests))
    fns = rng.integers(0, 2, n_requests)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in rng.integers(prompt_lens[0], prompt_lens[1] + 1, n_requests)]
    for ops in kernels.values():
        ops.launches = 0                       # count only the main path's launches
    t0 = time.monotonic()
    i = 0
    mem_samples, busy_samples = [], []
    registry.reset_slot = checked_reset
    try:
        while True:
            now = time.monotonic() - t0
            while i < n_requests and arrivals[i] <= now:
                cp.submit(ServeRequest(rid=i, fn=int(fns[i]), prompt=prompts[i],
                                       max_new_tokens=max_new_tokens, arrival_t=now), now)
                i += 1
            cp.tick(now)
            snap = cp.snapshot()
            mem_samples.append(snap["memory_bytes"])
            busy_samples.append(max(snap["busy_memory_bytes"], 1))
            if i >= n_requests and len(cp.completed) >= n_requests:
                break
            if now > 600:
                raise AssertionError(f"served {len(cp.completed)}/{n_requests} in 600 s")
            time.sleep(0.005)
    finally:
        registry.reset_slot = reset
    launches = {name: ops.launches for name, ops in kernels.items()}
    steps = backend.decode_steps
    wall = time.monotonic() - t0
    reuses = len(placed) - len(set(placed))

    if sorted(r.rid for r in cp.completed) != list(range(n_requests)):
        raise AssertionError("not every request was served")
    if recurrent and not reuses:
        raise AssertionError("no request was placed in a reused slot")
    for r in cp.completed:
        if len(r.output) != max_new_tokens or not all(0 <= x < cfg.vocab_size
                                                      for x in r.output):
            raise AssertionError(f"request {r.rid} returned {r.output}")
    per_step = per_step_launches(cfg, stack)
    for name, n in launches.items():
        if n != per_step[name] * steps or steps == 0:
            raise AssertionError(f"{name} launched {n} times in {steps} decode steps of "
                                 f"{cfg.name}; expected {per_step[name]} per step")
    lat = [r.done_t - r.arrival_t for r in cp.completed]
    phase("serve", arch=cfg.name, requests=n_requests, served=len(cp.completed),
          wall_s=f"{wall:.3f}", decode_steps=steps, launches_per_step=per_step,
          kernel_launches=launches, slot_reuses=reuses,
          p50_s=f"{np.percentile(lat, 50):.4f}", p99_s=f"{np.percentile(lat, 99):.4f}",
          cold_fraction=f"{np.mean([r.cold for r in cp.completed]):.3f}",
          creations=backend.creations, teardowns=backend.teardowns,
          cold_starts_s=[round(c, 4) for c in backend.cold_start_times],
          normalized_memory=f"{np.mean(mem_samples) / np.mean(busy_samples):.4f}",
          replica_bytes=max((backend.memory_bytes(i) for i in backend.replicas), default=0),
          max_memory_allocated=torch.cuda.max_memory_allocated())
    # free every replica before the next phase
    for iid in list(backend.replicas):
        backend.teardown(iid, time.monotonic() - t0)
    del cp, backend
    free_cuda()
    return launches


def counted(kernels: dict, fn):
    """Run fn with every kernel's launch count set to 0 just before and read
    just after -> (fn's result, launches per kernel)."""
    for ops in kernels.values():
        ops.launches = 0
    out = fn()
    return out, {name: ops.launches for name, ops in kernels.items()}


def zero_cache(cache) -> None:
    for layer in cache:
        for t in layer.values():
            t.zero_()


def rel_max_err(a, b) -> float:
    """max |a - b| / max |b| over float32 copies, a slice of rows at a time
    (the bf16 logits of a prefill are GBs)."""
    num = den = 0.0
    for i in range(0, a.shape[1], 512):
        x, y = a[:, i:i + 512].float(), b[:, i:i + 512].float()
        num = max(num, (x - y).abs().max().item())
        den = max(den, y.abs().max().item())
    return num / den


@contextlib.contextmanager
def annotated_scan():
    """hymba.selective_scan run inside a profiler range named SCAN_RANGE."""
    from repro_torch.models import hymba
    scan = hymba.selective_scan

    def call(*args):
        with torch.profiler.record_function(SCAN_RANGE):
            return scan(*args)
    hymba.selective_scan = call
    try:
        yield
    finally:
        hymba.selective_scan = scan


def prefill_phase(cfg, n_params: int, kernels: dict, plain: dict, registry, stack, *,
                  batch: int, seq: int, decode_steps: int, hold_logits: bool,
                  bound: float = PREFILL_VS_REF_BOUND, label: str = "") -> dict:
    """registry.prefill at full width from random weights: kernel launches per
    prefill, every kernel call held to its plain version on the model's own
    inputs, wall time and tokens/s, device busy time, peak memory, logits
    against attn_impl="ref" (held within ``bound`` when hold_logits, else
    reported, with routing flips on a moe arch).  With decode_steps, that many
    decode steps continue from the filled caches and are held within
    ``bound`` to one registry.forward over all the tokens.  Paths are named
    after ``label`` (default the arch).  Returns the launches of each path it
    drove.  whisper's prompt carries random frame embeddings from a seed (its
    frontend is a stub); on hymba the plain selective_scan's share of the
    profiled prefill is reported, on the device and on the host."""
    from repro_torch.models import moe
    label = label or cfg.name
    params = registry.init_params(cfg, device=DEVICE, seed=0)
    got = sum(t.numel() for t in registry.leaves(params))
    if got != n_params:
        raise AssertionError(f"{cfg.name} has {got} parameters, expected {n_params}")
    rng = np.random.default_rng(2)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, seq + decode_steps)),
                        dtype=torch.int32, device=DEVICE)
    frames = {}
    if cfg.family == "encdec":
        gen = torch.Generator(device=DEVICE).manual_seed(2)
        frames["enc_embeds"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                           generator=gen, device=DEVICE)
    prompt = {"tokens": toks[:, :seq], **frames}
    cache = registry.init_cache(cfg, batch, seq + decode_steps, device=DEVICE)
    expect = per_prefill_launches(cfg, stack, moe, batch * seq)
    paths = {}

    # the main path: one prefill, every kernel call recorded
    calls, routes_k = [], []

    def main_path():
        with recorded_calls(calls), recorded_routes(moe, routes_k):
            out = registry.prefill(cfg, params, cache, prompt)
        torch.cuda.synchronize()
        return out
    t0 = time.monotonic()
    (logits, _), paths[f"prefill.{label}"] = counted(kernels, main_path)
    first_s = time.monotonic() - t0
    if paths[f"prefill.{label}"] != expect:
        raise AssertionError(f"a prefill of {cfg.name} launched {paths[f'prefill.{label}']}"
                             f", expected {expect}")
    if logits.shape != (batch, seq, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} or not finite")
    spent = {}                                 # wall seconds of the phase's parts
    t0 = time.monotonic()
    call_err = hold_calls(calls, plain)
    spent["hold_calls"] = time.monotonic() - t0
    n_calls = {name: sum(c[0] == name for c in calls) for name in kernels}
    # K3 on the model's own inputs, where its time differs from random ones'
    k3_model = k3_on_model_inputs(calls, kernels["moe_gemm"]) if n_calls["moe_gemm"] else None
    del calls

    # timed and profiled prefills, each from a zeroed cache (an ssm prefill
    # starts from the cache's state), which they fill with the same values
    zero_cache(cache)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    registry.prefill(cfg, params, cache, prompt)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    zero_cache(cache)
    scan = {SCAN_RANGE: {}} if cfg.family == "hybrid" else {}
    t0 = time.monotonic()
    with annotated_scan() if scan else contextlib.nullcontext():
        prof_wall, kern, spans = device_kernels(
            lambda: registry.prefill(cfg, params, cache, prompt), ranges=scan)
    summ = kernel_summary(kern, spans, 1) if kern else None
    spent["profile_and_parse"] = time.monotonic() - t0

    # the same prefill under attn_impl="ref" on a cache of its own
    t0 = time.monotonic()
    routes_r = []
    ref_cache = registry.init_cache(cfg, batch, seq + decode_steps, device=DEVICE)
    with recorded_routes(moe, routes_r):
        ref_logits, _ = registry.prefill(cfg.replace(attn_impl="ref"), params, ref_cache,
                                         prompt)
    rel_ref = rel_max_err(logits, ref_logits)
    spent["ref_prefill"] = time.monotonic() - t0
    flips = sum(int((a != b).any(-1).sum()) for a, b in zip(routes_k, routes_r))
    del ref_cache, logits, ref_logits
    free_cuda()
    if hold_logits and rel_ref > bound:
        phase("prefill", arch=label, logits_rel_err_vs_ref=f"{rel_ref:.3g}",
              kernel_calls=n_calls, calls_max_abs_err_vs_plain=call_err)
        raise AssertionError(f"{label} prefill logits differ from attn_impl=ref by "
                             f"{rel_ref} (relative), bound {bound}")
    fields = dict(arch=label, batch=batch, seq=seq, params=got,
                  launches_per_prefill=paths[f"prefill.{label}"], kernel_calls=n_calls,
                  calls_max_abs_err_vs_plain={k: f"{v:.3g}" for k, v in call_err.items()},
                  first_prefill_s=f"{first_s:.3f}", prefill_s=f"{wall:.4f}",
                  tokens_per_s=f"{batch * seq / wall:.1f}", peak_memory_allocated=peak,
                  logits_rel_err_vs_ref=f"{rel_ref:.3g}",
                  logits_bound=bound if hold_logits else "reported, not held",
                  routing_flips_vs_ref=flips,
                  moe_tokens_routed=sum(int(r.shape[0] * r.shape[1]) for r in routes_k))
    if k3_model:
        fields["moe_gemm_on_model_inputs"] = k3_model
    if summ is None:
        fields["device_busy"] = "not measured (the profiler saw no kernels)"
    else:
        busy = summ["device_busy_ms"] / 1e3
        fields.update(profiled_wall_s=f"{prof_wall:.4f}", device_busy_s=f"{busy:.4f}",
                      idle_share=f"{1 - busy / prof_wall:.4f}",
                      kernels_per_prefill=summ["kernels"],
                      flash_attention=summ["flash_attention"], moe_gemm=summ["moe_gemm"],
                      rwkv6_scan=summ["rwkv6_scan"], top=repr(summ["top"]))
        for name, r in scan.items():
            # device_us 0 means the profiler tied no kernel to the range
            fields[name] = dict(
                calls=r["calls"], host_s=f"{r['host_us'] / 1e6:.4f}",
                host_share_of_wall=f"{r['host_us'] / 1e6 / prof_wall:.4f}",
                device_s=f"{r['device_us'] / 1e6:.4f}" if r["device_us"] else "not measured",
                device_share_of_busy=f"{r['device_us'] / 1e6 / busy:.4f}")

    if decode_steps:
        # decode from the filled caches (K1 reads the full caches K2's prefill
        # wrote; the ring caches are read at S > W; rwkv6 continues from the
        # state K4 left), then one forward over all the tokens, which the
        # decode logits are held to
        def decode():
            out = []
            for i in range(decode_steps):
                pos = torch.full((batch,), seq + i, dtype=torch.int32, device=DEVICE)
                lg, _ = registry.decode_step(cfg, params, cache, toks[:, seq + i:seq + i + 1],
                                             pos)
                out.append(lg[:, 0])
            torch.cuda.synchronize()
            return torch.stack(out, 1)
        t0 = time.monotonic()
        dec, paths[f"decode_after_prefill.{label}"] = counted(kernels, decode)
        per_step = per_step_launches(cfg, stack)
        want = {k: n * decode_steps for k, n in per_step.items()}
        if paths[f"decode_after_prefill.{label}"] != want:
            raise AssertionError(f"{decode_steps} decode steps after prefill launched "
                                 f"{paths[f'decode_after_prefill.{label}']}, expected {want}")
        (full, _), paths[f"forward.{label}"] = counted(
            kernels, lambda: registry.forward(cfg, params, {"tokens": toks, **frames}))
        want = per_prefill_launches(cfg, stack, moe, batch * (seq + decode_steps))
        if paths[f"forward.{label}"] != want:
            raise AssertionError(f"a forward of {cfg.name} launched "
                                 f"{paths[f'forward.{label}']}, expected {want}")
        rel_dec = rel_max_err(dec, full[:, seq:])
        spent["decode_and_forward"] = time.monotonic() - t0
        del full
        fields.update(decode_steps=decode_steps,
                      decode_launches=paths[f"decode_after_prefill.{label}"],
                      forward_launches=paths[f"forward.{label}"],
                      decode_vs_forward_rel_err=f"{rel_dec:.3g}")
        if not torch.isfinite(dec).all() or rel_dec > bound:
            phase("prefill", **fields)
            raise AssertionError(f"decode after prefill differs from forward by {rel_dec} "
                                 f"(relative), bound {bound}")
    fields["phase_parts_s"] = {k: round(v, 2) for k, v in spent.items()}
    phase("prefill", **fields)
    del params, cache
    free_cuda()
    return paths


# training: gemma3-4b at full width and depth, float32 parameters and AdamW state, bf16
# compute, every layer checkpointed, attn_impl="ref" (the kernels are forward only), one
# sequence of the JAX package's train_4k length; TRAIN_STEPS optimizer steps
TRAIN_B, TRAIN_S, TRAIN_STEPS = 1, 4096, 4
TRAIN_ADAMW = dict(lr=3e-4, warmup_steps=2, total_steps=100)
# step 0's chunked loss against the cross entropy of the full logits (bf16 logits, fp32 CE)
TRAIN_LOSS_BOUND = 1e-3
# the profiler range around the optimizer's update in the profiled step
ADAMW_RANGE = "train.adamw_update"
# every family at its smoke config in float32, on the card and on the CPU from one seed:
# the first step's gradients and the parameters after FAMILY_STEPS steps held within
# 1e-4 of each leaf's largest entry, the losses within rtol 1e-4.  Adam's m / sqrt(v)
# magnifies float32 rounding where a gradient component changes sign between steps, in
# proportion to lr: at lr 1e-3 the parameters of deepseek-v2-lite-16b missed that bound
# while its gradients held it, so the steps run at lr 1e-4
TRAIN_FAMILIES = ["gemma3-4b", "internvl2-76b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
                  "rwkv6-3b", "hymba-1.5b", "whisper-tiny"]
FAMILY_STEPS, FAMILY_LOSS_RTOL, FAMILY_TOL = 3, 1e-4, 1e-4
FAMILY_ADAMW = dict(lr=1e-4, warmup_steps=1, total_steps=10)


@contextlib.contextmanager
def timed_updates(optimizer, into: list):
    """optimizer.adamw_update run between two CUDA events (their pairs are
    appended to ``into``) and inside the profiler range ADAMW_RANGE."""
    update = optimizer.adamw_update

    def call(*args):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(ADAMW_RANGE):
            s.record()
            out = update(*args)
            e.record()
        into.append((s, e))
        return out
    optimizer.adamw_update = call
    try:
        yield
    finally:
        optimizer.adamw_update = update


def train_phase(cfg, n_params: int, registry, layers, tr) -> None:
    """TRAIN_STEPS optimizer steps of ``cfg`` through train_step at full width:
    step 0's chunked loss held to the cross entropy of registry.forward's
    logits, every loss and grad norm finite, the parameters moved by step 1;
    the step's wall (median of steps 2..), tokens/s, peak memory, the
    optimizer's share of the step (CUDA events around adamw_update), and one
    more step under the profiler: device busy, idle share, the optimizer's
    device time and the top device ops."""
    params = registry.init_params(cfg, device=DEVICE, seed=0)
    got = sum(t.numel() for t in registry.leaves(params))
    if got != n_params:
        raise AssertionError(f"{cfg.name} has {got} parameters, expected {n_params}")
    dc = tr.data.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S, global_batch=TRAIN_B)
    batches = [tr.data.torch_batch_at(dc, i, DEVICE) for i in range(TRAIN_STEPS + 1)]

    with torch.no_grad():
        chunked = registry.loss_fn(cfg, params, batches[0])[0].item()
        logits, _ = registry.forward(cfg, params, batches[0])
        full = layers.cross_entropy(logits, batches[0]["targets"],
                                    batches[0]["loss_mask"]).item()
        del logits
    free_cuda()
    loss_rel = abs(chunked - full) / abs(full)
    if not loss_rel <= TRAIN_LOSS_BOUND:
        raise AssertionError(f"chunked loss {chunked} against the full logits' {full}: "
                             f"{loss_rel} relative, bound {TRAIN_LOSS_BOUND}")

    state = tr.optimizer.adamw_init(params)
    step = tr.train_step.make_train_step(cfg, tr.train_step.TrainConfig(
        adamw=tr.optimizer.AdamWConfig(**TRAIN_ADAMW)))
    watched = [params["head"]["final_norm"], params["layers"][0]["attn"]["wq"],
               params["layers"][-1]["mlp"]["wo"]]
    before = [t.clone() for t in watched]
    torch.cuda.reset_peak_memory_stats()
    walls, updates, metrics = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.monotonic()
        with timed_updates(tr.optimizer, updates):
            params, state, m = step(params, state, batches[i])
            m = {k: v.item() for k, v in m.items()}           # the step's host sync
        walls.append(time.monotonic() - t0)
        metrics.append(m)
        if i == 0:
            moved = [(a - b).abs().max().item() for a, b in zip(watched, before)]
            if not all(x > 0 for x in moved):
                raise AssertionError(f"step 1 left parameters unchanged: {moved}")
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"step {i + 1}: non-finite metrics {m}")
    peak = torch.cuda.max_memory_allocated()
    del before
    opt_ms = [s.elapsed_time(e) for s, e in updates]
    wall = statistics.median(walls[1:])
    opt_share = statistics.median(o / 1e3 / w for o, w in zip(opt_ms[1:], walls[1:]))

    ranges = {ADAMW_RANGE: {}}
    with timed_updates(tr.optimizer, []):
        prof_wall, kern, spans = device_kernels(
            lambda: step(params, state, batches[TRAIN_STEPS]), ranges=ranges)
    fields = dict(arch=cfg.name, batch=TRAIN_B, seq=TRAIN_S, params=got,
                  param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
                  remat=cfg.remat, attn_impl=cfg.attn_impl, steps=TRAIN_STEPS,
                  loss=[f"{m['loss']:.5f}" for m in metrics],
                  grad_norm=[f"{m['grad_norm']:.5f}" for m in metrics],
                  lr=[f"{m['lr']:.3e}" for m in metrics],
                  chunked_vs_full_loss=f"{chunked:.6f} vs {full:.6f} ({loss_rel:.3g} rel, "
                                       f"bound {TRAIN_LOSS_BOUND})",
                  params_moved_by_step_1=[f"{x:.3g}" for x in moved],
                  step_s=[f"{w:.4f}" for w in walls], step_s_median_2_on=f"{wall:.4f}",
                  tokens_per_s=f"{TRAIN_B * TRAIN_S / wall:.1f}",
                  adamw_update_ms=[f"{o:.2f}" for o in opt_ms],
                  adamw_share_of_step=f"{opt_share:.4f}", peak_memory_allocated=peak)
    if not kern:
        fields["device_busy"] = "not measured (the profiler saw no kernels)"
    else:
        summ = kernel_summary(kern, spans, 1)
        busy = summ["device_busy_ms"] / 1e3
        upd = ranges[ADAMW_RANGE]
        # the profiler's host overhead (tens of thousands of launches a step) stretches
        # its wall: the idle share is also given against the unprofiled steps' median
        fields.update(profiled_step=TRAIN_STEPS + 1, profiled_wall_s=f"{prof_wall:.4f}",
                      device_busy_s=f"{busy:.4f}", idle_share=f"{1 - busy / prof_wall:.4f}",
                      idle_share_of_unprofiled_step=f"{1 - busy / wall:.4f}",
                      kernels_per_step=summ["kernels"],
                      adamw_update_device_s=f"{upd['device_us'] / 1e6:.4f}",
                      adamw_share_of_busy=f"{upd['device_us'] / 1e6 / busy:.4f}",
                      top=repr(summ["top"]))
    phase("train", **fields)
    del params, state, batches
    free_cuda()


def leaf_err(a, b, tr) -> float:
    """The largest over the leaves of max |a - b| / max |b| (b on the CPU)."""
    return max((x.cpu() - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
               for x, y in zip(tr.tree.leaves(a), tr.tree.leaves(b)))


def train_families_phase(get_smoke_config, registry, tr, kernels: dict) -> None:
    """FAMILY_STEPS training steps of every family's smoke config in float32 (every
    layer checkpointed) on the card and on the CPU from the same initial
    weights (made on the CPU from one seed) and batches: the first step's
    gradients and the final parameters held within FAMILY_TOL of each leaf's
    largest entry, the losses within FAMILY_LOSS_RTOL; the card leg launches
    no kernel of this repo."""
    for arch in TRAIN_FAMILIES:
        cfg = get_smoke_config(arch).replace(param_dtype="float32", compute_dtype="float32",
                                             remat="full")
        tcfg = tr.train_step.TrainConfig(adamw=tr.optimizer.AdamWConfig(**FAMILY_ADAMW))
        dc = tr.data.DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2,
                                mean_doc_len=24)
        rng = np.random.default_rng(3)
        extras = {}
        if cfg.family == "vlm":
            extras["patch_embeds"] = rng.standard_normal((2, cfg.num_patches, cfg.d_model))
        if cfg.family == "encdec":
            extras["enc_embeds"] = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model))
        init = registry.init_params(cfg, device="cpu", seed=0)
        runs = {}
        for device in (DEVICE, "cpu"):
            params = tr.tree.map_(lambda t, d=device: t.clone().to(d), init)
            state = tr.optimizer.adamw_init(params)
            step = tr.train_step.make_train_step(cfg, tcfg)
            ex = {k: torch.tensor(v, dtype=torch.float32, device=device)
                  for k, v in extras.items()}

            def run(params=params, state=state, step=step, device=device, ex=ex):
                grads = tr.train_step._grad_fn(cfg, params,
                                               tr.data.torch_batch_at(dc, 0, device, ex))[2]
                out = []
                for i in range(FAMILY_STEPS):
                    params, state, m = step(params, state,
                                            tr.data.torch_batch_at(dc, i, device, ex))
                    out.append({k: v.item() for k, v in m.items()})
                return out, grads, params
            t0 = time.monotonic()
            (metrics, grads, params), launched = counted(kernels, run)
            runs[device] = dict(metrics=metrics, grads=grads, params=params,
                                s=time.monotonic() - t0, launched=launched)
        card, cpu = runs[DEVICE], runs["cpu"]
        if any(card["launched"].values()):
            raise AssertionError(f"training {arch} launched kernels: {card['launched']}")
        loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(card["metrics"], cpu["metrics"]))
        grad_err = leaf_err(card["grads"], cpu["grads"], tr)
        param_err = leaf_err(card["params"], cpu["params"], tr)
        fields = dict(arch=arch, family=cfg.family, steps=FAMILY_STEPS,
                      loss_card=[f"{m['loss']:.6f}" for m in card["metrics"]],
                      loss_cpu=[f"{m['loss']:.6f}" for m in cpu["metrics"]],
                      loss_rel_err=f"{loss_rel:.3g}", grad_err_of_leaf_max=f"{grad_err:.3g}",
                      param_err_of_leaf_max=f"{param_err:.3g}",
                      card_s=f"{card['s']:.2f}", cpu_s=f"{cpu['s']:.2f}")
        phase("train.family", **fields)
        finite = all(np.isfinite(v) for m in card["metrics"] for v in m.values())
        if (not finite or loss_rel > FAMILY_LOSS_RTOL or grad_err > FAMILY_TOL
                or param_err > FAMILY_TOL):
            raise AssertionError(f"{arch}: the card's training run is off the CPU's: "
                                 f"loss {loss_rel}, grads {grad_err}, params {param_err}")


def train_restart_phase(get_smoke_config, registry, tr) -> None:
    """Four uninterrupted steps of the dense smoke config against two steps,
    checkpoint.save, restore_latest into fresh state, two more steps, under
    torch.use_deterministic_algorithms: losses and parameters bit-equal."""
    cfg = get_smoke_config("gemma3-4b").replace(param_dtype="float32",
                                                compute_dtype="float32")
    tcfg = tr.train_step.TrainConfig(adamw=tr.optimizer.AdamWConfig(**FAMILY_ADAMW))
    dc = tr.data.DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    # cuBLAS is deterministic under a fixed workspace, which torch then asks for
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        def fresh():
            params = registry.init_params(cfg, device=DEVICE, seed=0)
            return params, tr.optimizer.adamw_init(params)
        step = tr.train_step.make_train_step(cfg, tcfg)

        def steps(params, state, lo, hi):
            out = []
            for i in range(lo, hi):
                params, state, m = step(params, state, tr.data.torch_batch_at(dc, i, DEVICE))
                out.append(m["loss"].item())
            return params, state, out
        pa, _, losses_a = steps(*fresh(), 0, 4)
        pb, sb, losses_b = steps(*fresh(), 0, 2)
        tr.checkpoint.save(str(ckpt_dir), 2, {"p": pb, "o": sb}, extra={"arch": cfg.name})
        del pb, sb
        like_p, like_s = fresh()
        start, restored, extra = tr.checkpoint.restore_latest(str(ckpt_dir),
                                                              {"p": like_p, "o": like_s})
        pc, _, losses_c = steps(restored["p"], restored["o"], start, 4)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    diff = max((a - c).abs().max().item()
               for a, c in zip(tr.tree.leaves(pa), tr.tree.leaves(pc)))
    phase("train.restart", arch=cfg.name, restored_step=start, extra=extra,
          losses_uninterrupted=losses_a, losses_restarted=losses_b + losses_c,
          param_max_abs_diff=diff)
    if start != 2 or losses_a != losses_b + losses_c or diff != 0.0:
        raise AssertionError("the restarted run is not the uninterrupted one, bit for bit")


def no_kernel_grad_phase(kernels: dict, plain: dict, get_smoke_config, registry, tr) -> None:
    """Each kernel wrapper on the card (K2, K3 and K4 also through _launch) raises
    when an input requires grad under grad mode, and launches under
    torch.no_grad() (held to its plain version); a training step under
    attn_impl="kernel" raises before it updates anything."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    q, k, v = rand(1, 128, 4, 64), rand(1, 128, 2, 64), rand(1, 128, 2, 64)
    pos = torch.tensor([100], dtype=torch.int32, device=DEVICE)
    # fan-in scaled weights, as the models' (K3's bf16 designs round h to bf16)
    x, wg, wu, wo = rand(4, 16, 64), rand(4, 64, 128) / 8, rand(4, 64, 128) / 8, \
        rand(4, 128, 64) / 11.3
    r, kk, vv = rand(1, 64, 2, 64), rand(1, 64, 2, 64), rand(1, 64, 2, 64)
    lw, u = -rand(1, 64, 2, 64).abs().float(), rand(2, 64).float()
    k1, k2, k3, k4 = (kernels[n] for n in ("decode_attention", "flash_attention",
                                           "moe_gemm", "rwkv6_scan"))
    calls = [
        ("decode_attention", k1, lambda t: k1.decode_attention(t[0][:, :1], t[1], t[2], pos),
         lambda t: plain["decode_attention"](t[0][:, :1], t[1], t[2], pos), [q, k, v]),
        ("flash_attention", k2, lambda t: k2.flash_attention(*t),
         lambda t: plain["flash_attention"](*t), [q, k, v]),
        ("flash_attention", k2, lambda t: k2._launch("mma", *t),
         lambda t: plain["flash_attention"](*t), [q, k, v]),
        ("moe_gemm", k3, lambda t: k3.moe_expert_ffn(*t), lambda t: plain["moe_gemm"](*t),
         [x, wg, wu, wo]),
        ("moe_gemm", k3, lambda t: k3._launch("wgmma", *t), lambda t: plain["moe_gemm"](*t),
         [x, wg, wu, wo]),
        ("rwkv6_scan", k4, lambda t: k4.rwkv6_scan(*t)[0],
         lambda t: plain["rwkv6_scan"](*t)[0], [r, kk, vv, lw, u]),
        ("rwkv6_scan", k4, lambda t: k4._launch(*t, None, k4.SEGMENT)[0],
         lambda t: plain["rwkv6_scan"](*t)[0], [r, kk, vv, lw, u])]
    refused = {}
    for name, ops, call, ref, inputs in calls:
        for j in range(len(inputs)):
            ts = [t.clone().requires_grad_(n == j) for n, t in enumerate(inputs)]
            n0 = ops.launches
            try:
                call(ts)
            except RuntimeError as err:
                if "forward-only kernel" not in str(err) or ops.launches != n0:
                    raise
            else:
                raise AssertionError(f"{name} took an input that requires grad (input {j})")
            refused[name] = refused.get(name, 0) + 1
        with torch.no_grad():
            n0 = ops.launches
            out = call(inputs)
            if ops.launches != n0 + 1:
                raise AssertionError(f"{name} did not launch under no_grad")
        atol, rtol = call_tol(name, inputs[0].dtype)
        torch.testing.assert_close(out.float(), ref(inputs).float(), atol=atol, rtol=rtol)
    cfg = get_smoke_config("gemma3-4b").replace(attn_impl="kernel")
    params = registry.init_params(cfg, device=DEVICE, seed=0)
    state = tr.optimizer.adamw_init(params)
    before = [t.clone() for t in tr.tree.leaves(params)]
    batch = tr.data.torch_batch_at(tr.data.DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                                      global_batch=2), 0, DEVICE)
    try:
        tr.train_step.train_step(cfg, tr.train_step.TrainConfig(), params, state, batch)
    except RuntimeError as err:
        if "forward-only kernel" not in str(err):
            raise
        step_error = str(err)
    else:
        raise AssertionError("a training step under attn_impl=\"kernel\" returned a loss")
    if state["step"].item() != 0 or not all(
            torch.equal(a, b) for a, b in zip(tr.tree.leaves(params), before)):
        raise AssertionError("the refused training step changed the state")
    phase("train.no_kernel_grad", refused_calls=refused, launched_under_no_grad=len(calls),
          train_step_under_kernel=repr(step_error))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.control_plane import ControlPlane, TorchWorkerBackend
    from repro_torch.core.policies import make_policy
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.decode_attention import ops as k1_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_f64_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention import ops as k2_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bf16p_ref, visible
    from repro_torch.kernels.moe_gemm import moe_expert_ffn_ref
    from repro_torch.kernels.moe_gemm import ops as k3_ops
    from repro_torch.kernels.moe_gemm.ref import moe_expert_ffn_bf16h_ref
    from repro_torch.kernels.rwkv6_scan import ops as k4_ops
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_ref
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers, registry, stack
    from repro_torch.serving.engine import ModelReplica, ServeRequest
    from repro_torch.training import checkpoint, data, optimizer, train_step, tree
    tr = types.SimpleNamespace(checkpoint=checkpoint, data=data, optimizer=optimizer,
                               train_step=train_step, tree=tree)

    kernels = {"decode_attention": k1_ops, "flash_attention": k2_ops, "moe_gemm": k3_ops,
               "rwkv6_scan": k4_ops}
    plain = {"decode_attention": decode_attention_ref, "flash_attention": flash_attention_ref,
             "moe_gemm": moe_expert_ffn_ref, "rwkv6_scan": rwkv6_scan_ref,
             "moe_gemm_bf16h": moe_expert_ffn_bf16h_ref,
             # the bf16 K2 call's arithmetic at the key tile of the design its route runs
             "flash_attention_bf16p": lambda q, k, v, **kw: flash_attention_bf16p_ref(
                 q, k, v, block_k=k2_ops.block_k(k2_ops.route(q.dtype, q.shape[3]),
                                                 q.shape[3]), **kw)}
    paths: dict[str, dict] = {}                # launches per kernel on each driven path
    t_run = time.monotonic()

    def timed(name, fn, *args, **kw):
        t0 = time.monotonic()
        out = fn(*args, **kw)
        phase("wall", phase=name, seconds=f"{time.monotonic() - t0:.2f}",
              since_start=f"{time.monotonic() - t_run:.2f}")
        return out

    def bf16(arch):
        return get_config(arch).replace(param_dtype="bfloat16", remat="none",
                                        attn_impl="kernel")

    model_args = (kernels, plain, registry, stack, ModelReplica, ServeRequest)
    serve_args = (kernels, stack, ControlPlane, TorchWorkerBackend, make_policy, ServeRequest)
    timed("env", env_phase)
    timed("build", build_phase, kernels)
    k1 = timed("kernel", kernel_phase, k1_ops, decode_attention_ref, decode_attention_f64_ref)
    k3 = timed("kernel.moe_gemm", moe_gemm_phase, k3_ops, moe_expert_ffn_ref,
               moe_expert_ffn_bf16h_ref)
    k2 = timed("kernel.flash_attention", flash_attention_phase, k2_ops, flash_attention_ref,
               flash_attention_bf16p_ref, visible, k2_ops.build)
    k4 = timed("kernel.rwkv6_scan", rwkv6_scan_phase, k4_ops, rwkv6_scan_ref)

    gemma = bf16("gemma3-4b")
    paths["model.gemma3-4b"] = timed("model.gemma3-4b", model_phase, gemma, 3_879_925_248,
                                     8_087_006_208, *model_args)
    # 4 x ~8.1 GB resident, well under 80 GB
    paths["serve.gemma3-4b"] = timed(
        "serve.gemma3-4b", serve_phase, gemma, *serve_args, n_requests=8,
        prompt_lens=(64, 256), max_new_tokens=16, max_replicas=4)
    prefill_args = (kernels, plain, registry, stack)
    paths.update(timed("prefill.gemma3-4b", prefill_phase, gemma, 3_879_925_248,
                       *prefill_args, batch=PREFILL_B, seq=PREFILL_S_GEMMA,
                       decode_steps=DECODE_AFTER, hold_logits=True))

    moe = bf16("deepseek-moe-16b")
    paths["model.deepseek-moe-16b"] = timed(
        "model.deepseek-moe-16b", model_phase, moe, 16_377_694_208, 33_701_990_400,
        *model_args)
    mla = bf16("deepseek-v2-lite-16b")
    paths["model.deepseek-v2-lite-16b"] = timed(
        "model.deepseek-v2-lite-16b", model_phase, mla, 15_708_450_304, 31_551_118_336,
        *model_args)
    # 2 x 33.7 GB resident
    paths["serve.deepseek-moe-16b"] = timed(
        "serve.deepseek-moe-16b", serve_phase, moe, *serve_args, n_requests=6,
        prompt_lens=(32, 128), max_new_tokens=8, max_replicas=2)
    # B 2 x S 2048 = 4096 tokens: one dispatch group, C = 480
    paths.update(timed("prefill.deepseek-moe-16b", prefill_phase, moe, 16_377_694_208,
                       *prefill_args, batch=PREFILL_B, seq=PREFILL_S_MOE, decode_steps=0,
                       hold_logits=False))
    paths.update(timed("prefill.deepseek-v2-lite-16b", prefill_phase, mla, 15_708_450_304,
                       *prefill_args, batch=PREFILL_B, seq=PREFILL_S_MOE, decode_steps=0,
                       hold_logits=False))

    rwkv = bf16("rwkv6-3b")
    paths["model.rwkv6-3b"] = timed("model.rwkv6-3b", model_phase, rwkv, 3_099_691_520,
                                    6_241_981_440, *model_args)
    # 2 x 6.2 GB resident; 10 requests on at most 2 replicas of 2 slots: slots are reused
    paths["serve.rwkv6-3b"] = timed(
        "serve.rwkv6-3b", serve_phase, rwkv, *serve_args, n_requests=10,
        prompt_lens=(32, 128), max_new_tokens=8, max_replicas=2)
    # 32 K4 calls, then 8 decode steps from the state they leave, held to a forward over
    # 4104 tokens (4104 % 16 = 8: K4's tail masking): in bf16, timed, every call held, the
    # prefill logits reported; then in float32 at RWKV_HELD_LAYERS layers, the logits and
    # decode steps held within F32_LOGITS_BOUND
    paths.update(timed("prefill.rwkv6-3b", prefill_phase, rwkv, 3_099_691_520,
                       *prefill_args, batch=PREFILL_B, seq=PREFILL_S_GEMMA,
                       decode_steps=DECODE_AFTER, hold_logits=False))
    held = rwkv.replace(param_dtype="float32", compute_dtype="float32",
                        num_layers=RWKV_HELD_LAYERS)
    label = f"rwkv6-3b.f32.{RWKV_HELD_LAYERS}L"
    paths.update(timed(f"prefill.{label}", prefill_phase, held, registry.param_count(held),
                       *prefill_args, batch=PREFILL_B, seq=PREFILL_S_GEMMA,
                       decode_steps=DECODE_AFTER, hold_logits=True, bound=F32_LOGITS_BOUND,
                       label=label))

    hymba = bf16("hymba-1.5b")
    # K1 on the 3 full-cache layers of every decode step, at pos + 128
    paths["model.hymba-1.5b"] = timed("model.hymba-1.5b", model_phase, hymba, 1_662_468_800,
                                      3_432_007_040, *model_args)
    # 2 x 3.4 GB resident; 10 requests on at most 2 replicas of 2 slots: slots are reused
    paths["serve.hymba-1.5b"] = timed(
        "serve.hymba-1.5b", serve_phase, hymba, *serve_args, n_requests=10,
        prompt_lens=(32, 128), max_new_tokens=8, max_replicas=2)
    # 32 K2 calls at S 4224 (the prompt and the 128 meta tokens), then 8 decode steps held
    # to a forward over 4104 tokens
    paths.update(timed("prefill.hymba-1.5b", prefill_phase, hymba, 1_662_468_800,
                       *prefill_args, batch=PREFILL_B, seq=PREFILL_S_GEMMA,
                       decode_steps=DECODE_AFTER, hold_logits=True))

    whisper = bf16("whisper-tiny")
    # plain torch throughout: no kernel launches on any of its paths
    paths["model.whisper-tiny"] = timed("model.whisper-tiny", model_phase, whisper, 56_355_840,
                                        156_309_504, *model_args)
    paths["serve.whisper-tiny"] = timed(
        "serve.whisper-tiny", serve_phase, whisper, *serve_args, n_requests=8,
        prompt_lens=(64, 256), max_new_tokens=16, max_replicas=4)
    paths.update(timed("prefill.whisper-tiny", prefill_phase, whisper, 56_355_840,
                       *prefill_args, batch=PREFILL_B, seq=PREFILL_S_WHISPER,
                       decode_steps=DECODE_AFTER, hold_logits=True))

    # training, attn_impl="ref": no kernel of this repo on its path (they are forward only)
    train = get_config("gemma3-4b").replace(param_dtype="float32", compute_dtype="bfloat16",
                                            remat="full", attn_impl="ref")
    timed("train.gemma3-4b", train_phase, train, 3_879_925_248, registry, layers, tr)
    timed("train.families", train_families_phase, get_smoke_config, registry, tr, kernels)
    timed("train.restart", train_restart_phase, get_smoke_config, registry, tr)
    timed("train.no_kernel_grad", no_kernel_grad_phase, kernels, plain, get_smoke_config,
          registry, tr)

    def per_path(name):
        return {p: n[name] for p, n in paths.items()}
    rows = [
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:69", row=k1),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:95", row=k2),
        dict(name="moe_gemm", route="cuda",
             source="src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu",
             replaces="src/repro/kernels/moe_gemm/kernel.py:49", row=k3),
        dict(name="rwkv6_scan", route="cuda",
             source="src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
             replaces="src/repro/kernels/rwkv6_scan/kernel.py:72", row=k4)]
    out = []
    for r in rows:
        row = r.pop("row")
        launches = per_path(r["name"])
        # the timed shape's numbers; the rest (K1 at hymba's shape, K2's local,
        # moe and hymba layers and its mma.sync design, K3's occupied decode
        # and prefill calls, the tight holds' readings) ride along under their
        # own keys
        extra = {k: v for k, v in row.items() if k not in
                 ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        out.append(dict(r, launches=sum(launches.values()), launches_per_path=launches,
                        max_abs_err=row["max_abs_err"], ms=row["ms"],
                        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                        bound_by=row["bound_by"], library_ms=row["library_ms"], **extra))
    for r in out:
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} was never launched on the main paths")
    print(json.dumps({"kernels": out}), flush=True)
    # the run uses one card, device 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
