#!/usr/bin/env python3
"""Where K3's bf16 route moves from the weight stream to the wgmma GEMM.

    python3 tools/k3_route_sweep.py          # one CUDA card

Times both bf16 designs of the grouped expert FFN (``ops._launch``) at
deepseek-moe-16b's expert shape (E 64, d 2048, f 1408) at the capacities a
dispatch group fills that the stream takes (C 8 and 16, ``ops.STREAM_MAX_C``
its largest), with x filled as one dispatch group fills it (each token to 6
distinct experts of the 64 in arrival order up to capacity, the rest zero),
and with 12 of the 64 experts holding one token each (the decode call at 2
slots); device medians after a 1 GiB L2 flush (chip_smoke.py's ``time_ms``),
each output first held to the designs' arithmetic.  The card's name and power
limit, then one line per case.  Imports torch and repro_torch only.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import K3_BF16H_TOL, K3_DECODE, K3_OCCUPIED, time_ms  # noqa: E402
from repro_torch.kernels.moe_gemm import ops  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_expert_ffn_bf16h_ref  # noqa: E402

# (C, tokens of the dispatch group, or None: K3_OCCUPIED experts with one token each)
CASES = [(8, None), (8, 2), (8, 64), (16, 80), (16, 136)]
TOP_K = 6


def dispatch_like(x, tokens: int, gen) -> int:
    """Refill x (E, C, d) as one dispatch group fills it: ``tokens`` random
    tokens, each to TOP_K distinct experts in arrival order up to capacity, the
    rest zero.  Returns the number of occupied experts."""
    e, c, d = x.shape
    ids = torch.rand(tokens, e, generator=gen, device=x.device).argsort(-1)[:, :TOP_K]
    onehot = torch.zeros(tokens, e, device=x.device).scatter_(1, ids, 1.0)
    pos = torch.cumsum(onehot, 0) - onehot
    keep = (onehot > 0) & (pos < c)
    tok = (torch.randn(tokens, d, generator=gen, device=x.device) * 0.5).to(x.dtype)
    gi, ei = keep.nonzero(as_tuple=True)
    x.zero_()
    x[ei, pos[gi, ei].long()] = tok[gi]
    return int(keep.any(0).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_route_sweep: no CUDA device; this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    e, _, d, f = K3_DECODE
    dt = torch.bfloat16
    wg, wu = ((torch.randn(e, d, f, generator=gen, device="cuda") * d ** -0.5).to(dt)
              for _ in range(2))
    wo = (torch.randn(e, f, d, generator=gen, device="cuda") * f ** -0.5).to(dt)
    for c, tokens in CASES:
        x = torch.empty(e, c, d, dtype=dt, device="cuda")
        if tokens is None:
            x.zero_()
            picked = torch.randperm(e, generator=gen, device="cuda")[:K3_OCCUPIED]
            x[picked, 0] = (torch.randn(K3_OCCUPIED, d, generator=gen, device="cuda")
                            * 0.5).to(dt)
            occupied = K3_OCCUPIED
        else:
            occupied = dispatch_like(x, tokens, gen)
        tight = moe_expert_ffn_bf16h_ref(x, wg, wu, wo).float()
        us = {}
        for design in ("stream", "wgmma"):
            out = ops._launch(design, x, wg, wu, wo)
            torch.testing.assert_close(out.float(), tight, atol=K3_BF16H_TOL[0],
                                       rtol=K3_BF16H_TOL[1])
            us[design] = time_ms(lambda: ops._launch(design, x, wg, wu, wo), iters=30) * 1e3
        print(f"C={c} tokens={tokens if tokens is not None else 'one per occupied expert'} "
              f"occupied_experts={occupied} stream_us={us['stream']:.3f} "
              f"wgmma_us={us['wgmma']:.3f} faster={min(us, key=us.get)} "
              f"routed_to={ops.route(dt, c)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
