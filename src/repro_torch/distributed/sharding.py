"""Logical-axis sharding: one place that maps model-level axis names onto
physical mesh axes.

The port of ``repro.distributed.sharding``.  Models annotate tensors with
*logical* axes ("batch", "heads", "ffn", ...); the table below maps those
onto whatever mesh is active, so the same spec trees describe a single
device (no mesh -> no-op), the single-pod 16x16 mesh and the multi-pod
2x16x16 mesh.

* ``batch`` maps to ("pod", "data"): data parallelism spans pods so only
  gradient/metric all-reduces cross the slow links between pods.
* ``heads``/``kv_heads``/``ffn``/``experts``/``vocab`` map to "model"
  (tensor/expert parallelism stays inside a pod).
* A mesh may lack some axes (e.g. no "pod" on the single-pod mesh); unknown
  axes are silently dropped from the spec.

A spec is a tuple with one entry per tensor dim: ``None``, a mesh axis name
or a tuple of names (JAX's ``PartitionSpec``).  The mesh is :class:`Mesh`,
named axes with sizes and, where it is run on, the ``torch.device`` of
each position: ``torch.distributed``'s ``DeviceMesh`` needs an initialised
process group, and nothing here starts one.  ``sharding_for`` translates
JAX's ``NamedSharding(mesh, spec)`` into DTensor placements, one per mesh
axis.

The fluid engine's sharded dispatch (``repro_torch.core.simtorch``) runs
its shards from one process over a 1-D :func:`device_mesh`.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Optional, Sequence, Union

import torch

# logical axis -> physical mesh axis (or tuple of axes)
LOGICAL_RULES: dict[str, Union[str, tuple[str, ...], None]] = {
    "batch": ("pod", "data"),
    "expert_batch": ("pod", "data"),   # token dim inside MoE dispatch
    "seq": None,                        # sequence kept unsharded by default
    "seq_sp": "data",                   # sequence-parallel variant (opt-in)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "experts": "model",
    "expert_ffn": None,
    "vocab": "model",
    "kv_lora": None,
    # decode KV-cache sequence dim: sharded over "model" for MQA/low-kv-head
    # archs (split-K decode).  Only consulted when the kv-head dim cannot
    # shard (see attention.cache_specs).
    "kv_seq": "model",
    "state": None,
    "conv": None,
    "layers": None,
    "frames": None,
    "patches": None,
    "opt_state": ("data",),             # extra ZeRO-1 axis for optimizer moments
    "fsdp": ("data",),                  # FSDP/ZeRO-3 parameter axis
    # simulator axes (repro_torch.core.simtorch): the chunked run shards
    # its function axis over a 1-D "functions" mesh, and a fleet batch its
    # points over a 1-D "points" mesh
    "functions": "functions",
    "points": "points",
}

Spec = tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes with their sizes, and optionally the device of each
    position (row-major over the axes; ``None`` for a description that no
    code runs on, such as the production meshes)."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: Optional[tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a mesh of {self.size} positions was given "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


_state = threading.local()


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Install *mesh* as the ambient mesh used by :func:`shard`."""
    _state.mesh = mesh


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


class use_mesh:
    """Context manager installing an ambient mesh."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh
        self._prev: Optional[Mesh] = None

    def __enter__(self):
        self._prev = current_mesh()
        set_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_mesh(self._prev)
        return False


def _resolve(axis: Optional[str], mesh_axes: Sequence[str]):
    """Map one logical axis name to mesh axes present on the current mesh.

    Tuple rules stay tuples even when only one physical axis survives
    (``("pod", "data")`` on a pod-less mesh resolves to ``("data",)``, not
    ``"data"``), so that a spec's shape does not depend on which mesh is
    active.  String rules resolve to the bare axis name.
    """
    if axis is None:
        return None
    rule = LOGICAL_RULES.get(axis, None)
    if rule is None:
        return None
    if isinstance(rule, str):
        return rule if rule in mesh_axes else None
    present = tuple(a for a in rule if a in mesh_axes)
    return present or None


def logical_to_spec(logical: Sequence[Optional[str]], mesh: Optional[Mesh] = None) -> Spec:
    """Translate a tuple of logical axis names into a spec (``()`` without a
    mesh, as JAX's empty ``PartitionSpec``)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    mesh_axes = tuple(mesh.axis_names)
    return tuple(_resolve(a, mesh_axes) for a in logical)


def placements(spec: Spec, mesh: Mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh axis:
    ``Shard(dim)`` where that axis shards tensor dim ``dim``, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = {a: Replicate() for a in mesh.axis_names}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[a] = Shard(dim)
    return tuple(out[a] for a in mesh.axis_names)


def physical_spec(logical: Optional[Sequence[Optional[str]]], shape: Sequence[int],
                  mesh: Mesh) -> Spec:
    """The spec a leaf of logical spec ``logical`` and shape ``shape`` gets
    on ``mesh``: translated, then sanitized (the JAX package's
    ``launch.cells._with_shardings``, leaf by leaf)."""
    return sanitize_spec(logical_to_spec(logical or (), mesh), shape, mesh)


def sharding_for(logical: Sequence[Optional[str]], mesh: Optional[Mesh] = None):
    """The placements of a logical spec on the (ambient) mesh; ``None``
    without one."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    return placements(logical_to_spec(logical, mesh), mesh)


def device_mesh(devices: int, axis: str, device=None) -> Mesh:
    """1-D mesh of ``devices`` positions named ``axis``.

    With no ``device``, or a CUDA one, the positions are CUDA devices
    0 … devices-1, and fewer visible devices raise.  With a CPU
    ``device`` every position is the CPU: the counterpart of the JAX
    package's forced host-device count, which the CPU tests use.  The
    fluid engine's sharded dispatch builds its "functions" / "points"
    meshes here."""
    if devices < 1:
        raise ValueError(f"device_mesh needs >= 1 device, got {devices}")
    if device is not None and torch.device(device).type == "cpu":
        return Mesh((axis,), (devices,), (torch.device("cpu"),) * devices)
    avail = torch.cuda.device_count()
    if devices > avail:
        raise ValueError(
            f"device_mesh({devices}, {axis!r}): only {avail} local CUDA "
            f"device(s) visible — on the CPU pass device='cpu'")
    return Mesh((axis,), (devices,),
                tuple(torch.device("cuda", i) for i in range(devices)))


def sanitize_spec(spec: Spec, shape: Sequence[int], mesh: Mesh) -> Spec:
    """Drop mesh axes from dims they don't divide evenly (e.g. batch=1 decode,
    odd vocab sizes): sharding degrades gracefully instead of erroring."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        out.append(entry if size and shape[i] % size == 0 else None)
    return tuple(out)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Apply a sharding expressed in logical axes: the identity without a
    mesh or on a plain tensor, a ``redistribute`` on a DTensor."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = sanitize_spec(logical_to_spec(logical, mesh), x.shape, mesh)
    return x.redistribute(x.device_mesh, placements(spec, mesh))


def mesh_axis_size(logical_axis: str, mesh: Optional[Mesh] = None) -> int:
    """Product of physical mesh axis sizes a logical axis maps onto (1 if unmapped)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return 1
    rule = LOGICAL_RULES.get(logical_axis)
    if rule is None:
        return 1
    if isinstance(rule, str):
        rule = (rule,)
    size = 1
    for a in rule:
        if a in mesh.axis_names:
            size *= mesh.shape[a]
    return size


def div_axis(logical_axis: Optional[str], dim_size: int) -> Optional[str]:
    """Use *logical_axis* only if dim_size divides evenly on the current mesh."""
    if logical_axis is None:
        return None
    n = mesh_axis_size(logical_axis)
    if n <= 1 or dim_size % n != 0:
        return None
    return logical_axis


def _is_spec(leaf) -> bool:
    return leaf is None or isinstance(leaf, tuple)


def tree_map_specs(fn, spec_tree: Any, *rest: Any) -> Any:
    """``fn`` over the spec leaves (``None`` or a tuple) of a nested
    dict/list tree, with the leaves of ``rest`` trees of the same structure."""
    if _is_spec(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: tree_map_specs(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    return [tree_map_specs(fn, v, *(r[i] for r in rest))
            for i, v in enumerate(spec_tree)]


def spec_tree_to_shardings(spec_tree: Any, mesh: Mesh) -> Any:
    """Convert a tree of logical-axis tuples into placements (see
    :func:`sharding_for`); a ``None`` leaf is replicated."""
    return tree_map_specs(lambda leaf: placements(
        () if leaf is None else logical_to_spec(leaf, mesh), mesh), spec_tree)


def fsdp_specs(spec_tree: Any, shape_tree: Any, min_dim: int = 1024) -> Any:
    """ZeRO-3/FSDP: additionally shard each large weight over the data axis
    on its first free, evenly-divisible dimension.  ``shape_tree`` holds a
    tensor (``device="meta"`` will do) or a shape at each leaf."""
    n = mesh_axis_size("fsdp")

    def free(ax):  # dim is free if its logical axis maps to no mesh axis
        return ax is None or mesh_axis_size(ax) <= 1

    def f(spec, sd):
        shape = tuple(getattr(sd, "shape", sd))
        if spec is None:
            spec = (None,) * len(shape)
        if n <= 1 or len(shape) < 2:
            return spec
        out = list(spec)
        for i, (ax, dim) in enumerate(zip(spec, shape)):
            if free(ax) and dim >= min_dim and dim % n == 0:
                out[i] = "fsdp"
                break
        return tuple(out)

    return tree_map_specs(f, spec_tree, shape_tree)
