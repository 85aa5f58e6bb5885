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
each position.  ``sharding_for`` translates JAX's ``NamedSharding(mesh,
spec)`` into DTensor placements, one per mesh axis.

The models on a multi-device mesh: the caller starts a process group of
``mesh.size`` ranks (gloo processes, a threaded group, NCCL, or the fake
group that the dry run counts under), builds the ``DeviceMesh`` with
:func:`dtensor_mesh` and places the parameter, cache and input trees with
:func:`distribute_tree` by their logical spec trees (the counterpart of
``launch.cells._with_shardings``).  The models then run unchanged on the
DTensors under :class:`use_mesh`, and their ``shard(...)`` calls are
``redistribute``s to the logical spec's placements, JAX's
``with_sharding_constraint``.  The plain tensors a model makes inside itself
(rope angles, masks, ``arange``s, a loss's zeros) meet the DTensors as
replicated ones: ``use_mesh`` turns on DTensor's implicit replication while
it is entered (restoring the setting it found on exit), so no model code
wraps them.

The fluid engine's sharded dispatch (``repro_torch.core.simtorch``) runs
its shards from one process over a 1-D :func:`device_mesh`.
"""

from __future__ import annotations

import contextlib
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


def _dispatcher():
    from torch.distributed.tensor import DTensor
    return DTensor._op_dispatcher


class use_mesh:
    """Context manager installing an ambient mesh; with a mesh, plain tensors
    meet DTensors as replicated ones while it is entered (module
    docstring)."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh
        self._prev: Optional[Mesh] = None
        self._prev_implicit: Optional[bool] = None

    def __enter__(self):
        self._prev = current_mesh()
        set_mesh(self.mesh)
        if self.mesh is not None:
            d = _dispatcher()
            self._prev_implicit = d._allow_implicit_replication
            d._allow_implicit_replication = True
        return self.mesh

    def __exit__(self, *exc):
        set_mesh(self._prev)
        if self._prev_implicit is not None:
            _dispatcher()._allow_implicit_replication = self._prev_implicit
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


def dtensor_mesh(mesh: Mesh, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``mesh`` over the initialised default process
    group, whose world size must be ``mesh.size`` (``init_device_mesh``,
    which makes each mesh axis's sub-groups: build it once a group)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, mesh.axis_sizes, mesh_dim_names=mesh.axis_names)


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A process group of ``world`` ranks that moves no data, as rank
    ``rank``: the fake backend, under which a DTensor program runs one rank's
    local ops with every collective issued and none performed.  For counting
    only (``launch.op_analysis``); no value computed under it is held."""
    import sys

    import torch.distributed as dist
    from torch.distributed.tensor import _collective_utils as cu
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    # On a CPU DeviceMesh, or on meta shards, DTensor turns an all-to-all into
    # an all-gather and a chunk (gloo has no all-to-all).  Nothing is sent
    # here, so every module's reference to that helper is pointed at the
    # all-to-all the same program issues on a card's shards.
    orig = getattr(cu, "shard_dim_alltoall", None)
    swapped = [m for name, m in list(sys.modules.items())
               if name.startswith("torch.distributed.tensor") and m is not None
               and orig is not None and getattr(m, "shard_dim_alltoall", None) is orig]
    for m in swapped:
        m.shard_dim_alltoall = _alltoall
    try:
        yield
    finally:
        for m in swapped:
            m.shard_dim_alltoall = orig
        dist.destroy_process_group()


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    from torch.distributed import _functional_collectives as funcol
    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                 funcol._group_or_group_name(group))


def port_mesh(dmesh) -> Mesh:
    """The port's :class:`Mesh` description of a ``DeviceMesh``."""
    return Mesh(tuple(dmesh.mesh_dim_names), tuple(dmesh.mesh.shape))


def local_shape(shape: Sequence[int], spec: Spec, mesh: Mesh) -> tuple:
    """A rank's shard of a leaf of ``shape`` under a sanitized ``spec``: each
    dim split by the product of its mesh axes (which divides it)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None or i >= len(out):
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[i] //= mesh.shape[a]
    return tuple(out)


def distribute_leaf(t: torch.Tensor, logical: Optional[Sequence[Optional[str]]], dmesh):
    """One tensor placed on ``dmesh`` by its logical spec (``None``:
    replicated).  A real tensor, which every rank holds whole, is split
    where it lies, with no collective; a meta tensor becomes a DTensor whose
    local shard is a meta tensor of the rank's shape."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh = port_mesh(dmesh)
    spec = physical_spec(logical, tuple(t.shape), mesh)
    pl = _live_placements(spec, mesh)
    if t.is_meta:
        loc = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype, device="meta")
        return DTensor.from_local(loc, dmesh, pl, run_check=False, shape=t.shape,
                                  stride=t.stride())
    return distribute_tensor(t.to(dmesh.device_type), dmesh, pl, src_data_rank=None)


def _live_placements(spec: Spec, mesh: Mesh) -> tuple:
    """:func:`placements`, with an axis of size 1 replicated: a shard over one
    position is the whole tensor, and DTensor reshapes a replicated dim
    where it refuses a sharded one."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if n == 1 else p
                 for p, n in zip(placements(spec, mesh), mesh.axis_sizes))


def distribute_tree(tree: Any, logical_spec_tree: Any, dmesh) -> Any:
    """Place a tensor tree (nested dicts / lists) on ``dmesh`` leaf by leaf by
    its logical spec tree, each leaf's spec translated and sanitized for its
    shape (:func:`physical_spec`)."""
    if isinstance(tree, torch.Tensor):
        return distribute_leaf(tree, logical_spec_tree, dmesh)
    if isinstance(tree, dict):                 # the tensor tree's own key order
        return {k: distribute_tree(v, logical_spec_tree[k], dmesh) for k, v in tree.items()}
    return type(tree)(distribute_tree(v, sp, dmesh) for v, sp in zip(tree, logical_spec_tree))


def gather_tree(tree: Any) -> Any:
    """Every DTensor of a tree made whole on each rank (``full_tensor``); plain
    tensors and other leaves pass through."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v) for v in tree)
    return tree


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_map(fn, in_specs: Sequence[Spec], outs: Sequence[tuple], *args):
    """``fn(*args)``; on DTensor arguments, ``fn`` on the rank's local shards.

    Each argument is first held to its logical spec in ``in_specs`` (plain
    tensors count as replicated, ``None`` passes), so that the shards line up; each output
    of ``fn`` (a tuple) is then wrapped as a DTensor of the (logical spec,
    global shape) in ``outs``.  For a function that computes each shard from
    the matching shards alone (a recurrence over time that is independent
    per batch row and channel): it runs its local ops where DTensor would
    propagate shardings op by op.  Differentiable, through ``to_local`` and
    ``from_local``."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor
    dm = next(a.device_mesh for a in args if is_dtensor(a))
    mesh = port_mesh(dm)
    held = [None if a is None else shard(_as_dtensor(a, dm), *sp)
            for a, sp in zip(args, in_specs)]
    split = {i for a in held if a is not None
             for i, p in enumerate(a.placements) if p.is_shard()}
    # an argument whole along a mesh axis that splits another one gets a
    # partial gradient there (each rank's share of the sum)
    locs = [None if a is None else _ContiguousGrad.apply(a.to_local(grad_placements=[
        p if p.is_shard() or i not in split else _partial()
        for i, p in enumerate(a.placements)])) for a in held]
    res = fn(*locs)
    # contiguous: the global stride given below is a contiguous tensor's
    return tuple(
        DTensor.from_local(o.contiguous(), dm,
                           _live_placements(physical_spec(sp, shape, mesh), mesh),
                           run_check=False, shape=torch.Size(shape),
                           stride=contiguous_stride(shape))
        for o, (sp, shape) in zip(res, outs))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient comes back contiguous: a local function's
    backward may hand its inputs strided gradients, which DTensor's views
    (its reshapes of a layout it thinks contiguous) cannot take."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (an embedding lookup); on a DTensor table sharded by
    rows (the vocabulary over "model"), each rank looks up the ids its rows
    hold, zeros for the rest, and the result is a partial sum over the axes
    that shard the rows: DTensor would otherwise move the whole table to
    another sharding for every lookup.  Rows are gathered whole over any
    other axis first (a training cell's FSDP gather)."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    dm = table.device_mesh
    rows = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    table = table.redistribute(dm, [Shard(0) if r else Replicate() for r in rows])
    ids = shard(_as_dtensor(ids, dm), "batch", *([None] * (ids.dim() - 1)))
    id_pl = [Replicate() if r else p for r, p in zip(rows, ids.placements)]
    ids = ids.redistribute(dm, id_pl)
    # the table's gradient is a partial sum over the axes that split the ids
    loc = table.to_local(grad_placements=[
        Shard(0) if r else Partial() if p.is_shard() else Replicate()
        for r, p in zip(rows, id_pl)])
    _, off = compute_local_shape_and_global_offset(table.shape, dm, table.placements)
    i = ids.to_local().long() - off[0]
    hit = (i >= 0) & (i < loc.shape[0])
    out = loc[i.clamp(0, loc.shape[0] - 1)] * hit[..., None].to(loc.dtype)
    pl = [Partial() if r else p for r, p in zip(rows, id_pl)]
    shape = (*ids.shape, table.shape[1])
    return DTensor.from_local(out, dm, pl, run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _as_dtensor(x, dmesh):
    """``x``, a plain tensor that every rank holds whole taken as a
    replicated DTensor."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, dmesh, [_rep()] * dmesh.ndim, run_check=False)


def local_under(x, dmesh, pl):
    """``x`` (a DTensor, or a plain tensor every rank holds whole) as this
    rank's local tensor under placements ``pl``."""
    return _as_dtensor(x, dmesh).redistribute(dmesh, pl).to_local()


def _seq_local(cache):
    """-> (local cache, its offset along dim 1, the placements an update of
    the cache's dims takes: the cache's, replicated where a mesh axis
    shards dim 1)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    _, offset = compute_local_shape_and_global_offset(cache.shape, cache.device_mesh,
                                                      cache.placements)
    upd = [p if isinstance(p, Shard) and p.dim != 1 else Replicate()
           for p in cache.placements]
    return cache.to_local(), offset[1], upd


def write_seq(cache: torch.Tensor, new: torch.Tensor, index) -> torch.Tensor:
    """``cache[:, index] = new`` in place (``index`` a slice from 0 or a 1-D
    tensor of positions along dim 1, the same for every row); returns
    ``cache``.  On a DTensor cache the write is the rank's: ``new`` is
    redistributed to the cache's placements and written into the local
    shard at the positions that shard holds."""
    if not is_dtensor(cache):
        cache[:, index] = new
        return cache
    loc, off, pl = _seq_local(cache)
    new_l = local_under(new, cache.device_mesh, pl)
    tl = loc.shape[1]
    if isinstance(index, slice):
        n = len(range(cache.shape[1])[index])
        lo, hi = max(0, off), min(n, off + tl)
        if hi > lo:
            loc[:, lo - off:hi - off] = new_l[:, lo:hi]
        return cache
    idx = local_under(index, cache.device_mesh, [_rep()] * len(pl))
    _blend_put(loc, None, idx.long() - off, new_l, tl == cache.shape[1])
    return cache


def write_rows(cache: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``cache[b, slot[b]] = new[b]`` for every row ``b``, in place (cache
    (B, T, ...), slot (B,), new (B, ...)); returns ``cache``.  On a DTensor
    cache the write is the rank's, as :func:`write_seq`'s."""
    if not is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache.index_put_((rows, slot.long()), new)
        return cache
    from torch.distributed.tensor import Shard
    loc, off, pl = _seq_local(cache)
    dm = cache.device_mesh
    new_pl = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p for p in pl]
    new_l = local_under(new, dm, new_pl)
    slot_l = local_under(slot, dm, [p if isinstance(p, Shard) and p.dim == 0 else _rep()
                                    for p in pl])
    rows = torch.arange(loc.shape[0], device=loc.device)
    _blend_put(loc, rows, slot_l.long() - off, new_l, loc.shape[1] == cache.shape[1])
    return cache


def _rep():
    from torch.distributed.tensor import Replicate
    return Replicate()


def _partial():
    from torch.distributed.tensor import Partial
    return Partial()


def _blend_put(loc, rows, pos, new, whole: bool) -> None:
    """Write ``new`` at local positions ``pos`` of dim 1 (per row when
    ``rows`` is given).  Where a mesh axis shards dim 1 (not ``whole``), a
    position outside the local shard belongs to another rank and the shard
    keeps its value there."""
    if whole:
        if rows is None:
            loc[:, pos] = new
        else:
            loc.index_put_((rows, pos), new)
        return
    tl = loc.shape[1]
    inside = (pos >= 0) & (pos < tl)
    at = pos.clamp(0, tl - 1)
    if rows is None:
        # positions clamped onto the shard's edge may repeat a kept one: clear
        # the kept positions and add the update, both through zeros elsewhere
        keep = inside.view(1, -1, *([1] * (new.dim() - 2)))
        loc.index_add_(1, at, torch.where(keep, -loc[:, at], 0))
        loc.index_add_(1, at, torch.where(keep, new, 0))
    else:                                   # one position a row: no repeats
        keep = inside.view(-1, *([1] * (new.dim() - 1)))
        loc.index_put_((rows, at), torch.where(keep, new, loc[rows, at]))


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Apply a sharding expressed in logical axes: the identity without a
    mesh or on a plain tensor, a ``redistribute`` on a DTensor (its gradient
    held to the same placements: :class:`_Constrain`)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = sanitize_spec(logical_to_spec(logical, mesh), x.shape, mesh)
    return _Constrain.apply(x, _live_placements(spec, mesh))


class _Constrain(torch.autograd.Function):
    """``redistribute`` to placements ``pl`` whose gradient returns in the
    input's placements, as DTensor's own backward, but where the input was a
    partial sum: there it is held to ``pl``, as the transpose of JAX's
    ``with_sharding_constraint`` constrains the cotangent.  DTensor's
    backward would let a partial sum that the forward reduced (a residual
    after a row-parallel product) flow back unreduced, and every product of
    the backward would gather its weight to meet it."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = tuple(c if p.is_partial() else p for p, c in zip(x.placements, pl))
        return x.redistribute(x.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.pl), None


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
