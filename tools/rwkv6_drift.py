#!/usr/bin/env python3
"""How far two correct rwkv6-3b paths drift apart at full width, and where.

    python3 tools/rwkv6_drift.py [--out drift.jsonl]        # one CUDA card
    python3 tools/rwkv6_drift.py --device cpu --smoke        # a rehearsal

The model and prompt are chip_smoke.py's rwkv6-3b prefill phase: random
weights from seed 0, B 2, S 4096, tokens from numpy seed 2.  For bfloat16 and
float32, one forward under attn_impl="ref" is the reference, and each of these
forwards is compared with it:

  kernel         attn_impl="kernel": the wkv scan on K4
  scan_noise     "ref" with every wkv output times 1 + 1e-6 N(0, 1), per seed
  embed_noise    "ref" with the embeddings times 1 + 1e-6 N(0, 1), per seed: no
                 wkv output is touched, so any drift is the model's own (float32
                 only: so small a change of a bfloat16 embedding rounds away)
  gn_eps.*       the kernel and one scan_noise seed again, with the per-head
                 group norm's eps raised from 1e-6 to GN_EPS_WIDE and a
                 reference of its own: a counterfactual for the cause

A comparison reads max |a - b| / max |ref| of the logits at DEPTHS layers
(the head applied to the hidden state there, which is the forward of a model
cut to that depth), over all positions, over the first chunk (t < 16) and over
the rest, and the median over positions; and after every layer the same of the
hidden state.  The reference forward also reports, per layer, the per-head
standard deviation of the wkv output (what the group norm divides by) in the
first chunk and in the rest.  One line per comparison on stdout; every number,
per layer, as JSON lines to --out.  Imports torch, numpy and repro_torch only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.device import resolve_device, synchronize  # noqa: E402
from repro_torch.models import head, registry, rwkv6, stack  # noqa: E402

CHUNK = 16
NOISE = 1e-6
DEPTHS = (8, 32)
BATCH, SEQ, SMOKE_SEQ = 2, 4096, 40
SCAN_SEEDS, EMBED_SEEDS = 5, 3
GN_EPS_WIDE = 64e-5          # RWKV-6's own GroupNorm eps, 1e-5 x head_size_divisor 8 squared


@contextlib.contextmanager
def patched(module, name, fn):
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def scan_noise(seed: int, device):
    """rwkv6_scan_ref with its y times 1 + NOISE N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    plain = rwkv6.rwkv6_scan_ref

    def scan(*args, **kw):
        y, s = plain(*args, **kw)
        return y * (1 + NOISE * torch.randn(y.shape, generator=gen, device=y.device)), s
    return patched(rwkv6, "rwkv6_scan_ref", scan)


def wide_gn():
    norm = rwkv6._group_norm
    return patched(rwkv6, "_group_norm", lambda y, s, b, eps: norm(y, s, b, GN_EPS_WIDE))


def y_std_probe(into: list):
    """Record, per call of the group norm, the per-head std of the wkv output
    over the first chunk and the rest: (median, 1st percentile, min) each."""
    norm = rwkv6._group_norm

    def probe(y, s, b, eps):
        std = y.float().std(-1, correction=0)                    # (B, S, H)
        row = {}
        for part, x in (("first_chunk", std[:, :CHUNK]), ("rest", std[:, CHUNK:])):
            x = x.flatten()
            if x.numel():
                q = torch.quantile(x[:1 << 24], torch.tensor([0.5, 0.01], device=x.device))
                row[part] = [q[0].item(), q[1].item(), x.min().item()]
        into.append(row)
        return norm(y, s, b, eps)
    return patched(rwkv6, "_group_norm", probe)


def drift(a, b, scale: float) -> dict:
    """max |a - b| over the last axis, per position, over scale."""
    d = torch.stack([(x.float() - y.float()).abs().amax(-1)
                     for x, y in zip(a.split(1), b.split(1))])[:, 0] / scale      # (B, S)
    out = {"all": d.max().item(), "first_chunk": d[:, :CHUNK].max().item(),
           "median": d.median().item(), "argmax_t": int(d.amax(0).argmax())}
    out["rest"] = d[:, CHUNK:].max().item() if d.shape[1] > CHUNK else None
    return out


def absmax(x) -> float:
    return max(t.float().abs().max().item() for t in x.split(1))


def run(cfg, params, tokens, depths, ref=None, embed_seed=None) -> dict:
    """rwkv6.forward's loop, layer by layer.  Without ref, keep the hidden
    states and the logits at ``depths``; with ref, compare with them."""
    x = head.embed(cfg, params["head"], tokens)
    if embed_seed is not None:
        gen = torch.Generator(device=x.device).manual_seed(embed_seed)
        x = (x.float() * (1 + NOISE * torch.randn(x.shape, generator=gen, device=x.device))
             ).to(x.dtype)
    out = {"hidden": [], "logits": {}}
    for i, ((window, kind), p) in enumerate(zip(stack.layer_sigs(cfg), params["layers"])):
        x = rwkv6.layer_apply(cfg, p, x, window=window, kind=kind)
        if ref is None:
            out["hidden"].append((x, absmax(x)))
        else:
            h, scale = ref["hidden"][i]
            out["hidden"].append(drift(x, h, scale))
        if i + 1 in depths:
            lg = head.logits(cfg, params["head"], x)
            if ref is None:
                out["logits"][i + 1] = (lg, absmax(lg))
            else:
                r, scale = ref["logits"][i + 1]
                out["logits"][i + 1] = drift(lg, r, scale)
            del lg
    synchronize(x.device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--smoke", action="store_true",
                    help="rwkv6-3b's smoke config (2 layers, d_model 64), S 40")
    ap.add_argument("--out", default=None, help="JSON lines, every number")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    base = get_smoke_config("rwkv6-3b") if args.smoke else get_config("rwkv6-3b")
    seq = SMOKE_SEQ if args.smoke else SEQ
    depths = tuple(d for d in DEPTHS if d <= base.num_layers) or (base.num_layers,)
    rng = np.random.default_rng(2)
    tokens = torch.tensor(rng.integers(0, base.vocab_size, (BATCH, seq)),
                          dtype=torch.int32, device=device)
    out = open(args.out, "w") if args.out else None
    if device.type == "cuda":
        print(card(), flush=True)
    for dtype in ("bfloat16", "float32"):
        cfg = base.replace(param_dtype=dtype, compute_dtype=dtype, remat="none",
                           attn_impl="ref")
        params = registry.init_params(cfg, device=device, seed=0)
        t0 = time.monotonic()
        probe: list = []
        with torch.no_grad():
            with y_std_probe(probe):
                ref = run(cfg, params, tokens, depths)
            report(out, dtype, "ref", None, {"y_std": probe})
            cases = [("kernel", None, {})]
            cases += [("scan_noise", s, {}) for s in range(SCAN_SEEDS)]
            if dtype == "float32":
                cases += [("embed_noise", s, {"embed_seed": s})
                          for s in range(EMBED_SEEDS)]
            for name, seed, kw in cases:
                c = cfg.replace(attn_impl="kernel") if name == "kernel" else cfg
                ctx = scan_noise(seed, device) if name == "scan_noise" else contextlib.nullcontext()
                with ctx:
                    report(out, dtype, name, seed, run(c, params, tokens, depths, ref, **kw))
            del ref
            with wide_gn():
                ref = run(cfg, params, tokens, depths)
                report(out, dtype, "gn_eps.kernel", None,
                       run(cfg.replace(attn_impl="kernel"), params, tokens, depths, ref))
                with scan_noise(0, device):
                    report(out, dtype, "gn_eps.scan_noise", 0,
                           run(cfg, params, tokens, depths, ref))
            del ref
        print(f"[{dtype}] seconds={time.monotonic() - t0:.1f}", flush=True)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


def report(out, dtype: str, name: str, seed, res: dict) -> None:
    row = {"dtype": dtype, "case": name, "seed": seed, **res}
    if out:
        out.write(json.dumps(row) + "\n")
    if "logits" in res:
        parts = []
        for depth, d in res["logits"].items():
            rest = "n/a" if d["rest"] is None else f"{d['rest']:.3e}"
            parts.append(f"logits@{depth}L all={d['all']:.3e} first_chunk="
                         f"{d['first_chunk']:.3e} rest={rest} median={d['median']:.3e} "
                         f"argmax_t={d['argmax_t']}")
        hid = " ".join(f"{h['all']:.2e}" for h in res["hidden"])
        print(f"[{dtype}] {name} seed={seed} " + " | ".join(parts) + f" | hidden/layer {hid}",
              flush=True)
    else:
        first = " ".join(f"{r['first_chunk'][0]:.3g}/{r['first_chunk'][2]:.3g}"
                         for r in res["y_std"])
        rest = " ".join(f"{r['rest'][0]:.3g}/{r['rest'][2]:.3g}" for r in res["y_std"]
                        if "rest" in r)
        print(f"[{dtype}] ref y_std median/min per layer: first_chunk {first} | rest {rest}",
              flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
