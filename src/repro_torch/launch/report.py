"""Render the dry-run and roofline tables from the port's dry-run artifacts
(``launch.dryrun``); the counterpart of ``repro.launch.report``.

  PYTHONPATH=src python -m repro_torch.launch.report dryrun 16x16
  PYTHONPATH=src python -m repro_torch.launch.report roofline 1x1

Every time in them is a bound from ``launch.hopper``'s constants of one
H100, counted on the meta device, never a time taken on the card.
``model_flops`` is the JAX package's analytic count
(``benchmarks/roofline.py``), copied.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Optional

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch.dryrun import ARTIFACTS
from repro_torch.launch.hopper import PEAK_FLOPS


def _attn_flops_fwd(cfg, batch: int, seq: int, kind: str) -> float:
    """Forward score+output matmul FLOPs summed over layers (causal halved;
    sliding windows bound the key span; decode sees one query against the
    mean context seq/2).  SSM/linear-attention layers have no score matmul."""
    if cfg.family == "ssm":
        return 0.0
    from repro_torch.models.stack import layer_windows
    h, dh = cfg.num_heads, cfg.head_dim
    if cfg.use_mla:
        dh = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    total = 0.0
    for w in layer_windows(cfg):
        if kind == "decode":
            span = min(w or seq, seq / 2)
            total += 4.0 * batch * h * span * dh          # qlen = 1
        else:
            span = min(w or seq, seq)
            causal = 0.5 if span == seq else 1.0
            total += 4.0 * batch * seq * span * dh * h * causal
    return total


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic 'useful' FLOPs: parameter matmuls (6ND train / 2ND inference)
    + attention score/output matmuls.  Remat recompute, MoE dispatch einsums
    and capacity padding are deliberately excluded: the counted/model ratio
    exposes them as overhead."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * b * s + 3.0 * _attn_flops_fwd(cfg, b, s, "train")
    if shape.kind == "prefill":
        return 2.0 * n * b * s + _attn_flops_fwd(cfg, b, s, "prefill")
    return 2.0 * n * b + _attn_flops_fwd(cfg, b, s, "decode")


def _fmt_bytes(b: Optional[float]) -> str:
    return "-" if b is None else f"{b / 2**30:.2f}"


def load_cells(mesh: str, root: str = ARTIFACTS) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(root, f"*__{mesh}.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def dryrun_table(mesh: str, root: str = ARTIFACTS) -> str:
    rows = []
    for d in load_cells(mesh, root):
        if d.get("error"):
            rows.append(f"| {d['arch']} | {d['shape']} | ERROR | | | | |")
            continue
        if d.get("skipped"):
            continue
        mem, per = d["memory"], d["per_device"]
        coll = per["collective_bytes"]
        rows.append(
            f"| {d['arch']} | {d['shape']} | {d['lower_s']:.1f}s "
            f"| {_fmt_bytes(mem['argument_bytes'])} | {_fmt_bytes(mem['temp_bytes'])} "
            f"| {per['flops']:.2e} | {'-' if coll is None else f'{coll:.2e}'} |")
    head = ("| arch | shape | count | args GiB/dev | temp GiB/dev "
            "| FLOPs/dev | coll B/dev |\n|---|---|---|---|---|---|---|")
    return head + "\n" + "\n".join(rows)


def report(mesh: str = "16x16", root: str = ARTIFACTS) -> list[dict]:
    """Per counted cell: the roofline terms, the bound, model FLOPs over the
    counted FLOPs, and the model FLOPs' share of the peak in the bound time."""
    rows = []
    for d in load_cells(mesh, root):
        if d.get("error") or d.get("skipped"):
            continue
        terms = {k: v for k, v in d["roofline_s"].items() if v is not None}
        mf = model_flops(d["arch"], d["shape"])
        counted = d["per_device"]["flops"] * d["n_chips"]
        step = max(terms.values())
        rows.append(dict(arch=d["arch"], shape=d["shape"], mesh=mesh,
                         compute_s=terms["compute"], memory_s=terms["memory"],
                         collective_s=d["roofline_s"]["collective"],
                         bottleneck=d["bottleneck"], useful_ratio=mf / max(counted, 1e-9),
                         mfu=(mf / d["n_chips"] / step) / PEAK_FLOPS if step > 0 else 0.0))
    return rows


def roofline_table(mesh: str = "16x16", root: str = ARTIFACTS) -> str:
    rows = []
    for r in report(mesh, root):
        coll = r["collective_s"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s'] * 1e3:.1f} "
            f"| {r['memory_s'] * 1e3:.1f} | {'-' if coll is None else f'{coll * 1e3:.1f}'} "
            f"| {r['bottleneck']} | {r['useful_ratio']:.2f} | {r['mfu'] * 100:.1f}% |")
    head = ("| arch | shape | compute ms | memory ms | collective ms "
            "| bound | MODEL/COUNTED | roofline frac |\n|---|---|---|---|---|---|---|---|")
    return head + "\n" + "\n".join(rows)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "roofline"
    mesh = argv[1] if len(argv) > 1 else "16x16"
    print(dryrun_table(mesh) if which == "dryrun" else roofline_table(mesh))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
