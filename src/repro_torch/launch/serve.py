"""Serving launcher: autoscaled model serving on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --policy sync \\
      --keepalive 30 --duration 30 --rps 2 [--device cuda]

Runs the REAL control plane (repro_torch.core.control_plane) over real torch
model replicas (the arch's smoke config, bf16 params, the CUDA kernels:
decode attention, and the expert FFN for ``--arch deepseek-moe-16b`` or
``deepseek-v2-lite-16b``; ``--arch rwkv6-3b`` serves the ssm family, whose
one-token decode is plain torch; ``--arch hymba-1.5b`` the hybrid family,
decode attention on its full-attention layers beside a plain Mamba branch;
``--arch whisper-tiny`` the encoder-decoder family, plain torch against a
zero cross-attention cache, as the JAX replica serves it); prints the paper's
metrics for the run.  The device is
CUDA unless ``--device`` names another (``--device cpu`` runs the plain
torch path on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.control_plane import ControlPlane, TorchWorkerBackend
from repro_torch.core.policies import make_policy
from repro_torch.serving.engine import ServeRequest


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--policy", default="sync", choices=["sync", "async", "hybrid"])
    ap.add_argument("--keepalive", type=float, default=30.0)
    ap.add_argument("--window", type=float, default=10.0)
    ap.add_argument("--target", type=float, default=0.7)
    ap.add_argument("--cc", type=int, default=2)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--rps", type=float, default=1.0)
    ap.add_argument("--functions", type=int, default=2)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch).replace(param_dtype="bfloat16", remat="none",
                                              attn_impl="kernel")
    kw = {"container_concurrency": args.cc}
    if args.policy == "sync":
        kw["keepalive_s"] = args.keepalive
    elif args.policy == "async":
        kw.update(window_s=args.window, target=args.target)
    backend = TorchWorkerBackend(cfg, max_slots=args.cc, max_seq=64, device=args.device)
    cp = ControlPlane(backend, lambda f: make_policy(args.policy, **kw),
                      num_functions=args.functions)

    rng = np.random.default_rng(0)
    arrivals = np.sort(rng.uniform(0, args.duration,
                                   int(args.rps * args.duration)))
    fns = rng.integers(0, args.functions, len(arrivals))
    t0 = time.monotonic()
    i = 0
    mem_samples, busy_samples = [], []
    while True:
        now = time.monotonic() - t0
        while i < len(arrivals) and arrivals[i] <= now:
            cp.submit(ServeRequest(rid=i, fn=int(fns[i]), prompt=[1, 2, 3],
                                   max_new_tokens=args.max_new_tokens,
                                   arrival_t=now), now)
            i += 1
        cp.tick(now)
        snap = cp.snapshot()
        mem_samples.append(snap["memory_bytes"])
        busy_samples.append(max(snap["busy_memory_bytes"], 1))
        if i >= len(arrivals) and len(cp.completed) >= len(arrivals):
            break
        if now > args.duration + 120:
            break
        time.sleep(0.005)

    lat = [r.done_t - r.arrival_t for r in cp.completed]
    cold = [r.cold for r in cp.completed]
    print(f"device: {backend.device}")
    print(f"served {len(cp.completed)}/{len(arrivals)} requests")
    print(f"latency p50={np.percentile(lat,50):.2f}s p99={np.percentile(lat,99):.2f}s")
    print(f"cold fraction: {np.mean(cold)*100:.1f}%")
    print(f"instance creations: {backend.creations}, teardowns: {backend.teardowns}")
    print(f"measured cold starts: {[f'{c:.2f}' for c in backend.cold_start_times[:5]]}")
    print(f"normalized memory: {np.mean(mem_samples)/np.mean(busy_samples):.2f}")


if __name__ == "__main__":
    main()
