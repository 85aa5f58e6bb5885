#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the kernels are built from the sources in this
checkout at first use) and the repository's ``src/`` beside this file; it
exits non-zero without them.  Imports torch, numpy and ``repro_torch`` only.

Phases, one line of output each (``env`` prints the card's name and power
limit as nvidia-smi gives them on a line of its own):
  env     card, torch and CUDA versions; TF32 off for matmul and cuDNN
  build   nvcc of every kernel (process set-up, apart from cold starts)
  kernel  each kernel against its plain torch version at the main path's
          shapes, with its time, the plain time, one library call's time and
          the least time the card could take for the same work
  model   one full-width gemma3-4b replica (bf16): parameter count, bytes,
          cold start, decode-step time, a profiled decode step (device busy
          time against host wall time), kernel-vs-plain logits
  serve   ControlPlane + TorchWorkerBackend over full-width replicas; the
          decode kernel's launch count must be 5 x the decode steps taken
Then one JSON line of per-kernel numbers, and last the result line
``{"ok": true, "device": {...}}``.  Any failure ends the run non-zero.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # the _tol of tests/test_kernels.py

# main-path shapes: gemma3-4b global layers, 2 slots (= container concurrency)
B, T, H, KH, D = 2, 2048, 8, 4, 256
MAX_SLOTS, MAX_SEQ = B, T
N_REQUESTS, MAX_NEW_TOKENS = 8, 16
MAX_REPLICAS = 4                          # 4 x ~8.1 GB resident, well under 80 GB


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def time_ms(fn, iters: int = 50) -> float:
    """Median device time of one call, L2 flushed before each (the decode
    step streams ~8 GB of weights between two calls of one layer).  The 1 GiB
    flush also keeps the card busy (~0.3 ms) while the host enqueues the call,
    so the events time the device, not the host's launch overhead."""
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
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


def build_phase(ops) -> None:
    t0 = time.monotonic()
    lib = ops.library()
    secs = time.monotonic() - t0
    log = ops.build.library_path("decode_attention", ops.SOURCES).with_suffix(".log")
    usage = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    phase("build", kernel="decode_attention", seconds=f"{secs:.2f}", lib=Path(lib._name).name,
          ptxas=repr(" | ".join(usage[:12])))


def kernel_phase(ops, ref_fn) -> dict:
    """decode_attention against its plain version at the main-path shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, T, KH, D, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, T, KH, D, generator=gen, device="cuda").to(dtype)
        rand = torch.randint(1, T - 1, (B,), generator=gen, device="cuda")
        for softcap in (None, 50.0):
            for pos in ([0, T - 1], [T - 1, 0], rand.tolist()):
                p = torch.tensor(pos, dtype=torch.int32, device="cuda")
                out = ops.decode_attention(q, k, v, p, softcap=softcap)
                torch.cuda.synchronize()
                exp = ref_fn(q, k, v, p, softcap=softcap)
                if not torch.isfinite(out).all():
                    raise AssertionError(f"non-finite kernel output {dtype} {softcap} {pos}")
                err = (out.float() - exp.float()).abs().max().item()
                torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                                           rtol=TOL[dtype])
                worst = max(worst, err)
                phase("kernel.check", dtype=str(dtype).split(".")[1], softcap=softcap,
                      pos=pos, max_abs_err=f"{err:.3g}", tol=TOL[dtype])
        # garbage past pos leaves the output unchanged (keys past pos are never read)
        p = torch.tensor([40, 90], dtype=torch.int32, device="cuda")
        base = ops.decode_attention(q, k, v, p)
        k2, v2 = k.clone(), v.clone()
        k2[:, 100:] = 999.0
        v2[:, 100:] = -999.0
        moved = (ops.decode_attention(q, k2, v2, p).float() - base.float()).abs().max().item()
        if moved > 1e-6:
            raise AssertionError(f"keys past pos changed the output by {moved}")
        phase("kernel.position", dtype=str(dtype).split(".")[1], garbage_past_pos_moved=moved)

    # time at the serving dtype (bf16), no softcap (gemma3), the full cache (pos = T-1)
    dtype = torch.bfloat16
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, T, KH, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, T, KH, D, generator=gen, device="cuda").to(dtype)
    out = {}
    for label, pos in (("full", [T - 1] * B), ("serving", [200, 250])):
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        mask = (torch.arange(T, device="cuda")[None, :] <= p[:, None].long())[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib_err = (library().transpose(1, 2).float() - ref_fn(q, k, v, p).float()).abs().max()
        if lib_err.item() > TOL[dtype]:
            raise AssertionError(f"SDPA disagrees with the plain version by {lib_err.item()}")
        keys = sum(min(x, T - 1) + 1 for x in pos)
        es = q.element_size()
        nbytes = keys * KH * D * 2 * es + 2 * q.numel() * es + p.numel() * 4
        nops = keys * H * D * 4                       # q.k and p.v, 2 flops per MAC
        bound = max(nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS[dtype]) * 1e3
        row = dict(
            ms=time_ms(lambda: ops.decode_attention(q, k, v, p)),
            plain_ms=time_ms(lambda: ref_fn(q, k, v, p)),
            library_ms=time_ms(library),
            bound_ms=bound,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= nops / PEAK_OPS[dtype]
            else "operations")
        phase("kernel.time", pos=label, positions=pos, bytes=nbytes,
              kernel_us=f"{row['ms'] * 1e3:.3f}", plain_us=f"{row['plain_ms'] * 1e3:.3f}",
              library_us=f"{row['library_ms'] * 1e3:.3f}",
              bound_us=f"{row['bound_ms'] * 1e3:.4f}", bound_by=row["bound_by"],
              launches_so_far=ops.launches)
        out[label] = row
    return dict(out["full"], max_abs_err=worst)


def profile_steps(rep, steps: int = 10) -> None:
    """Where a warm decode step's time goes: the device's busy time (sum of
    kernel times; one stream, so kernels do not overlap) against the host's
    wall time.  The profiler adds host overhead, so this wall time is above
    an unprofiled step's."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for s in range(steps):
            rep.step(float(s))
        wall = (time.monotonic() - t0) / steps
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        phase("model.profile", device_busy="not measured (the profiler saw no kernels)")
        return
    busy = sum(e.self_device_time_total for e in kern) / steps / 1e6
    k1_calls = sum(e.count for e in kern if "decode_split_kernel" in e.key)
    k1_us = sum(e.self_device_time_total for e in kern if "decode_split_kernel" in e.key
                or "decode_combine_kernel" in e.key)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    phase("model.profile", steps=steps, wall_ms_per_step=f"{wall * 1e3:.3f}",
          device_busy_ms_per_step=f"{busy * 1e3:.3f}", idle_share=f"{1 - busy / wall:.4f}",
          kernels_per_step=f"{sum(e.count for e in kern) / steps:.1f}",
          decode_attention_calls=k1_calls,
          decode_attention_us_per_call=f"{k1_us / max(k1_calls, 1):.2f}",
          top=repr("; ".join(f"{e.key[:48]} {e.self_device_time_total / steps / 1e3:.3f}ms "
                             f"x{e.count / steps:.0f}" for e in top)))


def model_phase(cfg, registry, stack, ModelReplica, ServeRequest) -> None:
    n_params = registry.param_count(cfg)
    if n_params != 3_879_925_248:
        raise AssertionError(f"gemma3-4b has {n_params} parameters, expected 3879925248")
    rep = ModelReplica(cfg, max_slots=MAX_SLOTS, max_seq=MAX_SEQ, seed=0, device="cuda")
    rng = np.random.default_rng(1)
    for i in range(MAX_SLOTS):
        prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
        rep.add(ServeRequest(rid=i, fn=0, prompt=prompt, max_new_tokens=1), 0.0)
    step_s = []
    for s in range(40):
        t0 = time.monotonic()
        rep.step(float(s))                      # ends in the step's host sync
        step_s.append(time.monotonic() - t0)
    profile_steps(rep)
    # one step on the same weights and cache, kernel vs the plain attention
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (MAX_SLOTS, 1)), dtype=torch.int32,
                        device="cuda")
    pos = torch.tensor(rep._pos, device="cuda")
    logits = {}
    for impl in ("kernel", "ref"):
        cache = [{n: t.clone() for n, t in layer.items()} for layer in rep.cache]
        lg, _ = registry.decode_step(cfg.replace(attn_impl=impl), rep.params, cache, toks, pos)
        logits[impl] = lg.float()
    if not torch.isfinite(logits["kernel"]).all():
        raise AssertionError("non-finite logits")
    if logits["kernel"].shape != (MAX_SLOTS, 1, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(logits['kernel'].shape)}")
    rel = ((logits["kernel"] - logits["ref"]).abs().max()
           / logits["ref"].abs().max()).item()
    if rel > 2e-2:
        raise AssertionError(f"kernel vs plain logits differ by {rel} (relative)")
    n_global = sum(w is None for w in stack.layer_windows(cfg))
    phase("model", arch=cfg.name, params=n_params, global_layers=n_global,
          memory_bytes=rep.memory_bytes(), cold_start_s=f"{rep.cold_start_s:.4f}",
          decode_step_ms_median=f"{statistics.median(step_s[5:]) * 1e3:.3f}",
          decode_step_ms_min=f"{min(step_s[5:]) * 1e3:.3f}",
          pos=rep._pos.tolist(), logits_rel_err_kernel_vs_ref=f"{rel:.3g}")
    del rep, cache, logits
    gc.collect()
    torch.cuda.empty_cache()


def serve_phase(cfg, ops, stack, ControlPlane, TorchWorkerBackend, make_policy,
                ServeRequest) -> int:
    torch.cuda.reset_peak_memory_stats()
    backend = TorchWorkerBackend(cfg, max_slots=MAX_SLOTS, max_seq=MAX_SEQ, device="cuda")
    cp = ControlPlane(backend, lambda f: make_policy("sync", keepalive_s=30.0,
                                                      container_concurrency=MAX_SLOTS),
                      num_functions=2, fleet=ReplicaCap(MAX_REPLICAS))
    rng = np.random.default_rng(0)
    arrivals = np.sort(rng.uniform(0, 4.0, N_REQUESTS))
    fns = rng.integers(0, 2, N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in rng.integers(64, 257, N_REQUESTS)]
    ops.launches = 0                           # count only the main path's launches
    t0 = time.monotonic()
    i = 0
    mem_samples, busy_samples = [], []
    while True:
        now = time.monotonic() - t0
        while i < N_REQUESTS and arrivals[i] <= now:
            cp.submit(ServeRequest(rid=i, fn=int(fns[i]), prompt=prompts[i],
                                   max_new_tokens=MAX_NEW_TOKENS, arrival_t=now), now)
            i += 1
        cp.tick(now)
        snap = cp.snapshot()
        mem_samples.append(snap["memory_bytes"])
        busy_samples.append(max(snap["busy_memory_bytes"], 1))
        if i >= N_REQUESTS and len(cp.completed) >= N_REQUESTS:
            break
        if now > 600:
            raise AssertionError(f"served {len(cp.completed)}/{N_REQUESTS} in 600 s")
        time.sleep(0.005)
    launches, steps = ops.launches, backend.decode_steps
    wall = time.monotonic() - t0

    if sorted(r.rid for r in cp.completed) != list(range(N_REQUESTS)):
        raise AssertionError("not every request was served")
    for r in cp.completed:
        if len(r.output) != MAX_NEW_TOKENS or not all(0 <= x < cfg.vocab_size for x in r.output):
            raise AssertionError(f"request {r.rid} returned {r.output}")
    per_step = sum(w is None for w in stack.layer_windows(cfg))
    if launches != per_step * steps or steps == 0:
        raise AssertionError(f"decode kernel launched {launches} times in {steps} decode "
                             f"steps; expected {per_step} per step")
    lat = [r.done_t - r.arrival_t for r in cp.completed]
    phase("serve", requests=N_REQUESTS, served=len(cp.completed), wall_s=f"{wall:.3f}",
          decode_steps=steps, kernel_launches=launches,
          p50_s=f"{np.percentile(lat, 50):.4f}", p99_s=f"{np.percentile(lat, 99):.4f}",
          cold_fraction=f"{np.mean([r.cold for r in cp.completed]):.3f}",
          creations=backend.creations, teardowns=backend.teardowns,
          cold_starts_s=[round(c, 4) for c in backend.cold_start_times],
          normalized_memory=f"{np.mean(mem_samples) / np.mean(busy_samples):.4f}",
          replica_bytes=max((backend.memory_bytes(i) for i in backend.replicas), default=0),
          max_memory_allocated=torch.cuda.max_memory_allocated())
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.control_plane import ControlPlane, TorchWorkerBackend
    from repro_torch.core.policies import make_policy
    from repro_torch.kernels.decode_attention import decode_attention_ref, ops
    from repro_torch.models import registry, stack
    from repro_torch.serving.engine import ModelReplica, ServeRequest

    env_phase()
    build_phase(ops)
    k1 = kernel_phase(ops, decode_attention_ref)
    cfg = get_config("gemma3-4b").replace(param_dtype="bfloat16", remat="none",
                                          attn_impl="kernel")
    model_phase(cfg, registry, stack, ModelReplica, ServeRequest)
    launches = serve_phase(cfg, ops, stack, ControlPlane, TorchWorkerBackend, make_policy,
                           ServeRequest)
    kernels = [{
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:69",
        "launches": launches, "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
