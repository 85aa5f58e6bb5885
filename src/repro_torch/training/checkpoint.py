"""Step-atomic checkpointing (fault tolerance), counterpart of
``repro.training.checkpoint``, with its on-disk protocol.

Layout:  <dir>/step_00000100/   one <leaf name>.npy per leaf + meta.json
(``step``, ``leaves``, ``extra``) + the ``COMMITTED`` sentinel.  Writes go to
a ``.tmp`` dir that is renamed into place (atomic on POSIX), so a crash
mid-save never corrupts the latest checkpoint; ``restore_latest`` skips
incomplete checkpoints, and ``keep`` bounds disk usage.  A leaf's name joins
its tree path with ``_`` (``p_layers_0_attn_wq``).  numpy has no bfloat16:
a bf16 leaf is saved as its int16 bits and restored bit-exact into a bf16
leaf of the tree it is restored into.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.training import tree as tree_util

_SENTINEL = "COMMITTED"


def _name(path: tuple) -> str:
    return "_".join(str(k) for k in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if like.dtype == torch.bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names = []
    for path, leaf in tree_util.with_paths(tree):
        name = _name(path)
        np.save(os.path.join(tmp, f"{name}.npy"), _to_numpy(leaf))
        names.append(name)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "leaves": names, "extra": extra or {}}, f)
    with open(os.path.join(tmp, _SENTINEL), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _complete(path: str) -> bool:
    return os.path.exists(os.path.join(path, _SENTINEL))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and _complete(os.path.join(ckpt_dir, d)):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, tree_like):
    """-> (a tree of ``tree_like``'s structure, dtypes and devices, extra)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not _complete(path):
        raise FileNotFoundError(f"incomplete/missing checkpoint {path}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    arrays = {name: np.load(os.path.join(path, f"{name}.npy")) for name in meta["leaves"]}
    leaves = [_from_numpy(arrays[_name(p)], leaf) for p, leaf in tree_util.with_paths(tree_like)]
    return tree_util.unflatten(tree_like, leaves), meta["extra"]


def restore_latest(ckpt_dir: str, tree_like):
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    tree, extra = restore(ckpt_dir, step, tree_like)
    return step, tree, extra
