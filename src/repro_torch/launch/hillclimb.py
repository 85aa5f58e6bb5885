"""Variant runner: count one cell under a named variant and report its
roofline terms; the counterpart of ``repro.launch.hillclimb``.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch granite-34b \
      --shape decode_32k --variant unroll

The cell runs on the meta device as one rank of the 16x16 mesh
(``launch.dryrun.count_rank``); the terms, the collective one included, are
against the H100's constants (``launch.hopper``).  Variants that
change nothing in the eager port give the baseline's numbers: ``unroll``
(``scan_layers`` only groups ``stack.compute_runs``' runs; the layers run
one by one either way) and ``qblock1k`` (reserved in the JAX package too).
``kv_seq`` sets ``LOGICAL_RULES["kv_seq"]`` for the call and restores it.
"""

from __future__ import annotations

import argparse
import json

VARIANTS: dict[str, dict] = {
    "baseline": {},
    # decode
    "unroll": {"overrides": {"scan_layers": False}},
    "unroll_seqshard": {"overrides": {"scan_layers": False}, "kv_seq": "model"},
    # train
    "remat_dots": {"overrides": {"remat": "dots"}},
    "micro4": {"n_microbatches": 4},
    "micro16": {"n_microbatches": 16},
    "micro4_dots": {"n_microbatches": 4, "overrides": {"remat": "dots"}},
    "no_fsdp": {"fsdp": False},
    "ragged_moe": {"overrides": {"moe_impl": "ragged"}},
    "ragged_micro4": {"overrides": {"moe_impl": "ragged"}, "n_microbatches": 4},
    "cap10": {"overrides": {"capacity_factor": 1.0}},
    "micro4_cap10": {"n_microbatches": 4, "overrides": {"capacity_factor": 1.0}},
    "qblock1k": {"qblock": 1024},
    "scores_bf16": {"overrides": {"attn_scores_dtype": "bfloat16"}},
    "scores_bf16_micro4": {"overrides": {"attn_scores_dtype": "bfloat16"},
                           "n_microbatches": 4},
}


def run(arch: str, shape: str, variant: str) -> dict:
    import time

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import cells as cell_lib
    from repro_torch.launch import dryrun
    from repro_torch.launch.hopper import HBM_BW, LINK_BW, PEAK_FLOPS

    spec = dict(VARIANTS[variant])
    kv_seq = spec.pop("kv_seq", None)
    spec.pop("qblock", None)       # the query block is fixed in the model; reserved
    cfg = get_config(arch)
    if spec.get("overrides"):
        cfg = cfg.replace(**spec["overrides"])
    m = dryrun.make_mesh("16x16")
    prev = shlib.LOGICAL_RULES["kv_seq"]
    if kv_seq:
        shlib.LOGICAL_RULES["kv_seq"] = kv_seq
    try:
        t0 = time.time()
        cell, args, r = dryrun.count_rank(cfg, shape, m, fsdp=spec.get("fsdp", True),
                                          n_microbatches=spec.get("n_microbatches"))
        count_s = time.time() - t0
        arg_bytes = cell_lib.argument_bytes(cell, args, m)
    finally:
        shlib.LOGICAL_RULES["kv_seq"] = prev
    out = {
        "arch": arch, "shape": shape, "variant": variant,
        "compile_s": round(count_s, 1),
        "compute_ms": r["flops_per_device"] / PEAK_FLOPS * 1e3,
        "memory_ms": r["bytes_per_device"] / HBM_BW * 1e3,
        "collective_ms": r["collective_bytes_per_device"] / LINK_BW * 1e3,
        "temp_gib": r["temp_bytes"] / 2**30,
        "arg_gib": arg_bytes / 2**30,
        "collectives": r["collectives"],
    }
    out["step_ms_bound"] = max(out["compute_ms"], out["memory_ms"], out["collective_ms"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    args = ap.parse_args(argv)
    out = run(args.arch, args.shape, args.variant)
    out.pop("collectives")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
