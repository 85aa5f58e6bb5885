"""Op-level cost model of the port's eager programs: the counterpart of
``repro.launch.hlo_analysis``.

The JAX package costs the optimized HLO of a compiled cell.  The port has no
HLO: it runs eagerly, one aten op after another, so :class:`OpCounter` (a
``TorchDispatchMode``) costs each op as it is dispatched.  Run on the
``meta`` device the program allocates nothing and computes nothing, yet
every op dispatches with its real shapes, so a full-width cell is counted
exactly on a machine without a card.

Conventions (``hlo_analysis``' rules, as they translate to eager ops):

* **flops**: matmul-like ops through ``torch.utils.flop_counter``'s
  registered formulas (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``convolution``, the SDPA ops), so that they equal ``FlopCounterMode``'s
  count of the same run; an op of :data:`REDUCTIONS` costs 1 a input
  element; any other op that computes costs 1 an output element; an op that
  only moves data (:data:`MOVES`) costs none.
* **bytes**: every op that materializes reads its inputs and writes its
  outputs, each once, at the bytes of the tensor it is given (a view counts
  its own elements, never its whole storage).  A destination that is
  written and not read (``copy_``, ``fill_``, an ``out=`` argument) counts
  only as written: ``copy_`` into a slice is charged at twice the slice,
  the dynamic-update-slice rule.  An in-place scatter (``index_put_`` and
  the like) is charged twice the update plus its indices, and a gather
  (``index``, ``index_select``, ``embedding``) twice its output plus its
  indices, as ``hlo_analysis`` charges ``scatter`` and ``gather``.
* **free**: views, ``detach``, metadata queries and the ops of
  :data:`FREE` (the counterpart of ``_FREE_OPS``).
* **host ops**: an op none of whose tensors lies on the counted device
  (``device_type``: a Python scalar made into a CPU tensor and ``.item()``
  on it, in a meta or CUDA run) is the host's and is not counted.
* **no trip counts**: the port's loops are Python loops, so every
  iteration dispatches and is counted as it runs.
* **live bytes and peak**: each storage an op makes is added to the live
  bytes when it is made and taken off when it dies (a ``weakref.finalize``
  on the storage), so :attr:`OpCounter.peak_bytes` is the eager program's
  peak above what was live before it ran.  XLA's temp is smaller than this
  for the same program, because XLA fuses elementwise chains.
* **one rank on a mesh**: a cell on a mesh larger than one device runs on
  DTensors (``launch.cells``) under a process group of ``mesh.size`` ranks
  (the fake group, which moves no data, for counting).  A dispatch mode
  entered above a DTensor program sees each op at the DTensors' global
  shapes, so the counter steps aside for an op on DTensors
  (``NotImplemented``): DTensor's own dispatch then runs the op's sharding
  propagation and calls the local op on the rank's shards, and that local
  op dispatches under this mode with the rank's shapes, where it is counted.
  The ops DTensor's propagation runs on fake tensors to learn output shapes
  are not the program's and are not counted.
* **collectives**: the functional collectives (``_c10d_functional``, and
  ``_dtensor.shard_dim_alltoall``) that DTensor's redistributions issue are
  seen as ops on the rank's tensors and counted under ``hlo_analysis``'
  names and rule: ``all-reduce``,
  ``all-gather``, ``reduce-scatter`` and ``all-to-all``, each with a
  ``count`` and ``bytes``; the bytes are the input's for reduce-scatter and
  all-to-all and the larger of input and output otherwise, and they also
  add input plus output to ``bytes``.  ``wait_tensor`` is free.

The hand-written kernels are not aten ops: a kernel wrapper launches
through ``ctypes``, out of this mode's sight, and raises on a meta tensor.
The dry run therefore counts only ``attn_impl="ref"`` cells, as the JAX
package's dry run does (a Pallas ``custom-call`` there costs 0 FLOPs); a
cell with ``attn_impl="kernel"`` is refused (``launch.cells``).
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import defaultdict
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.sharding import is_dtensor

aten = torch.ops.aten

#: ops that neither compute nor move data (views are found from the schema)
FREE = {aten.detach, aten.alias, aten.lift_fresh, aten.empty_like, aten.empty,
        aten.empty_strided, aten.new_empty, aten.new_empty_strided, aten.set_,
        aten.resize_, aten._local_scalar_dense, aten.is_nonzero, aten.equal,
        aten._unsafe_view, aten.unsqueeze_, aten.squeeze_, aten.transpose_, aten.t_,
        aten.as_strided_, aten.detach_, aten.swapdims_}
#: ops that move data but compute nothing: 0 FLOPs, their bytes counted
MOVES = {aten.copy_, aten._to_copy, aten.clone, aten.cat, aten.stack, aten.fill_,
         aten.zero_, aten.zeros, aten.ones, aten.full, aten.zeros_like, aten.ones_like,
         aten.full_like, aten.new_zeros, aten.new_ones, aten.new_full, aten.scalar_tensor,
         aten.arange, aten.constant_pad_nd, aten.repeat, aten.repeat_interleave,
         aten.index, aten.index_select, aten.gather, aten.embedding, aten.take,
         aten.index_put_, aten._index_put_impl_, aten.index_put, aten.index_copy_,
         aten.scatter_, aten.scatter, aten.masked_scatter_, aten.slice_scatter,
         aten.select_scatter, aten.diagonal_scatter, aten.as_strided_scatter,
         aten.flip, aten.roll, aten.tril, aten.triu,
         aten.expand_copy, aten.permute_copy, aten.view_copy, aten.t_copy,
         aten.transpose_copy, aten.unsqueeze_copy, aten.squeeze_copy,
         aten.split_with_sizes_copy, aten.unbind_copy, aten.select_backward,
         aten.slice_backward}
#: gathers: twice the output plus the indices
GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding, aten.take}
#: in-place scatters: twice the update plus the indices; argument name of the update
SCATTERS = {aten.index_put_: "values", aten._index_put_impl_: "values",
            aten.index_copy_: "source", aten.index_add_: "source", aten.scatter_: "src",
            aten.scatter_add_: "src", aten.scatter_reduce_: "src",
            aten.masked_scatter_: "source"}
#: destinations that are written and not read (besides every ``out=`` argument)
WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_, aten.random_, aten.uniform_,
              aten.normal_, aten.bernoulli_, aten.exponential_}
#: reductions: 1 FLOP a input element
REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min, aten.prod,
              aten.var, aten.std, aten.var_mean, aten.std_mean, aten.norm,
              aten.linalg_vector_norm, aten.logsumexp, aten.all, aten.any, aten.argmax,
              aten.argmin, aten.topk, aten.sort, aten.cumsum, aten.cumprod,
              aten._softmax, aten._log_softmax, aten._softmax_backward_data,
              aten._log_softmax_backward_data, aten.nll_loss_forward,
              aten.nll_loss_backward, aten.native_layer_norm, aten.native_group_norm,
              aten.searchsorted, aten.count_nonzero}
#: what ``FlopCounterMode`` passes through untouched (metadata queries)
_QUERIES = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
            aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
            aten.is_non_overlapping_and_dense.default, aten.size.default,
            aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
            aten.storage_offset.default, aten.sym_storage_offset.default,
            aten.numel.default, aten.sym_numel.default, aten.dim.default,
            torch.ops.prim.layout.default}
_PKG = "/repro_torch/"
#: functional collectives -> hlo_analysis' name
COLLECTIVES = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all", "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "broadcast": "all-reduce", "shard_dim_alltoall": "all-to-all"}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d_functional",
                  "_dtensor")


@dataclasses.dataclass
class Counts:
    """What a run costs: totals, and per (aten op, calling site) the FLOPs,
    bytes and calls (``breakdown`` reads them).  Adds, subtracts and scales,
    so that equal iterations can be extrapolated exactly."""
    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes: float = 0.0
    ops: int = 0
    by_site: dict = dataclasses.field(default_factory=lambda: defaultdict(lambda: [0.0, 0.0, 0]))
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)

    def combine(self, other: "Counts", mult: float = 1.0) -> "Counts":
        """``self + mult * other`` as a new ``Counts``."""
        out = Counts(self.flops + mult * other.flops,
                     self.matmul_flops + mult * other.matmul_flops,
                     self.bytes + mult * other.bytes, int(self.ops + mult * other.ops),
                     collective_bytes=self.collective_bytes + mult * other.collective_bytes)
        for src, m in ((self, 1.0), (other, mult)):
            for kind, v in src.collectives.items():
                slot = out.collectives.setdefault(kind, {"count": 0, "bytes": 0.0})
                slot["count"] = int(round(slot["count"] + m * v["count"]))
                slot["bytes"] += m * v["bytes"]
        for src, m in ((self, 1.0), (other, mult)):
            for key, (f, b, n) in src.by_site.items():
                slot = out.by_site[key]
                slot[0] += m * f
                slot[1] += m * b
                slot[2] = int(slot[2] + m * n)
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, into=None) -> list:
    """The tensors of nested tuples, lists and dicts, in order (a DTensor's
    local shard in its place)."""
    into = [] if into is None else into
    if isinstance(tree, torch.Tensor):
        into.append(tree.to_local() if is_dtensor(tree) else tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, into)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, into)
    return into


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s tensors."""
    return sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _tensors(tree)}.values())


def _site() -> str:
    """The calling site of the op being dispatched: the autograd node when a
    backward runs it, else the innermost frame of the port outside this
    package's launch tooling (``models/attention.py:_attn_core``)."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"backward:{node.name()}"
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if _PKG in name and _PKG + "launch/" not in name:
            return f"{name.split(_PKG, 1)[1]}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


class OpCounter(TorchDispatchMode):
    """Count what the ops dispatched under it cost (module docstring).

    ``sites=True`` also keeps the costs per (aten op, calling site), which
    :func:`breakdown` ranks; it costs a frame walk an op.  ``hold(tree)``
    enters the tensors of a tree (the cell's arguments) into the live bytes
    before a run, so that the peak includes them."""

    def __init__(self, *, sites: bool = False, device_type: str = "meta"):
        super().__init__()
        self.counts = Counts()
        self.sites = sites
        self.device_type = device_type
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: dict[int, int] = {}

    # -- live bytes ------------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        s = t.untyped_storage()
        key = s._cdata
        if key in self._storages:
            return
        n = s.nbytes()
        self._storages[key] = n
        self.live_bytes += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    def hold(self, tree) -> int:
        """Enter ``tree``'s tensors into the live bytes -> their storages' bytes."""
        before = self.live_bytes
        for t in _tensors(tree):
            self._track(t)
        return self.live_bytes - before

    # -- dispatch ---------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if types and any(t is not torch.Tensor and t is not torch.nn.Parameter for t in types):
            if any(issubclass(t, _dtensor_type()) for t in types):
                return NotImplemented            # counted as DTensor's local op
            return func(*args, **kwargs)         # propagation's fake tensors
        rule = _RULES.get(func)
        if rule is None:
            rule = _RULES[func] = _rule(func)
        if rule is _QUERY:
            return NotImplemented
        if rule is _VIEW:                   # no new storage, no traffic
            return func(*args, **kwargs)
        # as FlopCounterMode: an op that decomposes is counted as its parts
        if rule[1]:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if rule[0] == "collective":
            self._collective(func, args, kwargs, out)
        else:
            self._count(func, rule[0], args, kwargs, out)
        return out

    def _collective(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        if outs and _is_fake(outs[0]):
            return
        for t in outs:
            self._track(t)
        name = COLLECTIVES[func.overloadpacket.__name__]
        nin = sum(_nbytes(t) for t in _tensors(kwargs, _tensors(args)))
        nout = sum(_nbytes(t) for t in outs)
        cb = nin if name in ("reduce-scatter", "all-to-all") else max(nin, nout)
        c = self.counts
        slot = c.collectives.setdefault(name, {"count": 0, "bytes": 0.0})
        slot["count"] += 1
        slot["bytes"] += cb
        c.collective_bytes += cb
        c.bytes += nin + nout
        c.ops += 1
        if self.sites:
            key = f"{name}:{_site()}"
            c.by_site[key][1] += nin + nout
            c.by_site[key][2] += 1

    def _count(self, func, kind, args, kwargs, out) -> None:
        outs = _tensors(out)
        if outs and _is_fake(outs[0]):
            return
        ins = _tensors(kwargs, _tensors(args))
        dev = self.device_type
        if not any(t.device.type == dev for t in outs) \
                and not any(t.device.type == dev for t in ins):
            return                                   # the host's
        for t in outs:
            self._track(t)
        if kind == "free":
            return
        packet = func.overloadpacket
        schema = func._schema
        dests = set() if not schema.is_mutable else {
            id(a) for arg, a in _schema_args(schema, args, kwargs)
            if arg.alias_info is not None and arg.alias_info.is_write
            and isinstance(a, torch.Tensor)
            and (arg.kwarg_only or packet in WRITE_ONLY or packet in SCATTERS)}
        if packet in SCATTERS:
            upd = next((a for arg, a in _schema_args(schema, args, kwargs)
                        if arg.name == SCATTERS[packet]), None)
            n_upd = _nbytes(upd) if isinstance(upd, torch.Tensor) else 0
            idx = sum(_nbytes(t) for t in ins
                      if id(t) not in dests and t is not upd and not t.is_floating_point())
            nbytes = 2 * n_upd + idx
        elif packet in GATHERS:
            idx = sum(_nbytes(t) for t in ins if not t.is_floating_point())
            nbytes = 2 * sum(_nbytes(t) for t in outs) + idx
        else:
            nbytes = sum(_nbytes(t) for t in ins if id(t) not in dests) \
                + sum(_nbytes(t) for t in outs)
        mm = 0.0
        if kind == "matmul":
            mm = flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        elif kind == "move":
            flops = 0.0
        elif kind == "reduce":
            flops = float(ins[0].numel()) if ins else 0.0
        else:
            flops = float(outs[0].numel()) if outs else 0.0
        c = self.counts
        c.flops += flops
        c.matmul_flops += mm
        c.bytes += nbytes
        c.ops += 1
        if self.sites:
            slot = c.by_site[f"{packet.__name__}:{_site()}"]
            slot[0] += flops
            slot[1] += nbytes
            slot[2] += 1


_QUERY, _VIEW = "query", "view"
_RULES: dict = {}


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _rule(func):
    """How an op is counted: ``_QUERY`` (passed through, as
    ``FlopCounterMode`` does), ``_VIEW``, or (kind, may decompose) with kind
    one of "free", "matmul", "move", "reduce", "elementwise", "collective"."""
    if func in _QUERIES:
        return _QUERY
    if isinstance(func, torch._ops.OpOverload) and func.is_view:
        return _VIEW
    packet = func.overloadpacket
    if getattr(func, "namespace", None) in _COLLECTIVE_NS:
        return ("collective" if packet.__name__ in COLLECTIVES else "free"), False
    kind = ("free" if packet in FREE else "matmul" if packet in flop_registry
            else "move" if packet in MOVES else "reduce" if packet in REDUCTIONS
            else "elementwise")
    return kind, func is not torch.ops.prim.device.default


def _schema_args(schema, args, kwargs):
    """(schema argument, value) of every argument given."""
    out = []
    for i, arg in enumerate(schema.arguments):
        if arg.kwarg_only or i >= len(args):
            if arg.name in kwargs:
                out.append((arg, kwargs[arg.name]))
        else:
            out.append((arg, args[i]))
    return out


def breakdown(counts: Counts, top: int = 20, key: str = "bytes") -> list[tuple[float, str]]:
    """The ``top`` (aten op, calling site) tags by ``key`` ("bytes",
    "flops" or "ops") -> [(value, tag)], largest first.  Needs a counter
    run with ``sites=True``; the counterpart of ``hlo_analysis.breakdown``."""
    col = {"flops": 0, "bytes": 1, "ops": 2}[key]
    return sorted(((v[col], k) for k, v in counts.by_site.items() if v[col]),
                  reverse=True)[:top]


def analyze(fn: Callable, *args, sites: bool = False, held=None) -> dict:
    """Run ``fn(*args)`` under an :class:`OpCounter` -> the keys of
    ``hlo_analysis.analyze_hlo_text`` (one rank's, on DTensor arguments),
    plus
    ``peak_bytes`` (the live bytes' peak, ``args`` included),
    ``temp_bytes`` (the peak less the arguments), ``argument_bytes``,
    ``output_bytes`` (the storages of the result that are not arguments'),
    ``matmul_flops``, ``ops`` and the raw ``counts``.  ``held`` is the tree
    whose tensors count as the arguments (``args`` if None)."""
    first = _tensors(args if held is None else held)
    counter = OpCounter(sites=sites, device_type=first[0].device.type if first else "meta")
    arg_bytes = counter.hold(args if held is None else held)
    arg_keys = set(counter._storages)
    with counter:
        out = fn(*args)
    seen, out_bytes = set(), 0
    for t in _tensors(out):
        if t.device.type != counter.device_type:
            continue
        s = t.untyped_storage()
        if s._cdata not in arg_keys and s._cdata not in seen:
            seen.add(s._cdata)
            out_bytes += s.nbytes()
    del out
    c = counter.counts
    return {"flops_per_device": c.flops, "bytes_per_device": c.bytes,
            "collective_bytes_per_device": c.collective_bytes,
            "collectives": {k: dict(v) for k, v in c.collectives.items()},
            "matmul_flops": c.matmul_flops, "ops": c.ops,
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "peak_bytes": counter.peak_bytes, "temp_bytes": counter.peak_bytes - arg_bytes,
            "counts": c}
