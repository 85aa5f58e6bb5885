"""Build the (step fn, stand-in inputs) pair of every (arch x shape) cell of
the dry run: the counterpart of ``repro.launch.cells``.

The JAX package's stand-ins are ``ShapeDtypeStruct``s with
``NamedSharding``s, so that a cell lowers and compiles without allocating.
The port's are tensors on ``torch.device("meta")`` at their global shapes:
the port's real step functions run on them eagerly, allocating nothing (the
dry run counts them, ``launch.op_analysis``).  Beside each argument tree the
cell carries its spec tree (each leaf's physical spec on the mesh, sanitized
as JAX's ``_with_shardings`` does) and the DTensor placements of every leaf,
the counterpart of the ``NamedSharding``s.

Cell kinds:
  train    -> the full ``train_step`` (forward, backward, AdamW), float32
              params and moments, FSDP specs
  prefill  -> ``registry.prefill`` into a seq_len-deep cache, bf16 params,
              no remat
  decode   -> ``registry.decode_step``: one token against a seq_len-deep
              cache, bf16 params

Cells run as ``get_config`` gives them (``attn_impl="ref"``): the kernels
launch through ``ctypes``, which no dispatch mode sees, and raise on meta
tensors, so a cell under ``attn_impl="kernel"`` is refused.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import Mesh
from repro_torch.models import registry
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import TrainConfig, train_step

META = torch.device("meta")


class StandIn(NamedTuple):
    """What the JAX package's ``ShapeDtypeStruct`` with a ``NamedSharding``
    says of a leaf: its global shape, dtype and placements on the mesh."""
    shape: tuple
    dtype: torch.dtype
    placements: tuple


@dataclasses.dataclass
class Cell:
    """A cell's step function, called as ``cell(*args)``, with what the dry
    run reads beside it: the physical spec tree and the placements tree of
    each argument (same structure as the argument), the kind, and the
    microbatch count of a train cell."""
    fn: Callable
    kind: str
    specs: tuple
    placements: tuple
    n_microbatches: int = 1

    def __call__(self, *args):
        return self.fn(*args)


def _physical(tensors, logical, mesh: Mesh):
    """Each leaf's physical spec on ``mesh`` (a ``None`` logical spec is
    replicated)."""
    return shlib.tree_map_specs(lambda sp, t: shlib.physical_spec(sp, tuple(t.shape), mesh),
                                logical, tensors)


def _batch(cfg: ModelConfig, shape: ShapeConfig, *, train: bool, rows: Optional[int] = None):
    """-> (batch tensors, their logical specs); ``rows`` overrides the
    global batch (the dry run's microbatch trip count)."""
    b, s = rows or shape.global_batch, shape.seq_len
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
    if train:
        batch["targets"] = torch.empty((b, s), dtype=torch.int32, device=META)
        batch["loss_mask"] = torch.empty((b, s), dtype=torch.float32, device=META)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.empty((b, cfg.num_patches, cfg.d_model),
                                            dtype=torch.bfloat16, device=META)
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                                          dtype=torch.bfloat16, device=META)
    return batch, registry.batch_specs(cfg, train=train)


def serving_config(cfg: ModelConfig, kind: str = "decode") -> ModelConfig:
    """Serving cells: bf16 weights, no remat; decode with ``scan_layers``
    off, prefill with it on, as the JAX package's.  In the port
    ``scan_layers`` only groups ``stack.compute_runs``' runs: the eager
    layers run one by one either way."""
    return cfg.replace(param_dtype="bfloat16", remat="none",
                       scan_layers=(kind != "decode"))


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> int:
    """Gradient-accumulation depth that keeps a device's microbatch at about
    8k tokens (4k for models 6144 wide or wider) while the microbatch still
    shards over the batch axes."""
    dp = shlib.mesh_axis_size("batch", mesh)
    tokens_per_dev = shape.global_batch * shape.seq_len // max(dp, 1)
    target = 4096 if cfg.d_model >= 6144 else 8192
    n = 1
    while tokens_per_dev // n > target and shape.global_batch // (2 * n) >= dp:
        n *= 2
    return n


def build_cell(cfg: ModelConfig, shape_name: str, mesh: Mesh, *,
               fsdp: bool = True, n_microbatches: Optional[int] = None,
               overrides: Optional[dict] = None, dmesh=None):
    """-> (fn, args, donate): ``fn(*args)`` runs the cell on the meta
    stand-ins ``args``; ``fn`` is a :class:`Cell` that also carries the
    specs and placements of every leaf.  ``donate`` names the arguments the
    JAX package donates (the port updates them in place).  With ``dmesh``
    (the ``DeviceMesh`` of ``mesh`` over a process group of ``mesh.size``
    ranks) every argument is a DTensor placed by its spec, whose local
    shard is a meta tensor of the rank's shape: the cell runs one rank's
    program."""
    if overrides:
        cfg = cfg.replace(**overrides)
    return _build_cell(cfg, shape_name, mesh, fsdp=fsdp, n_microbatches=n_microbatches,
                       dmesh=dmesh)


def _build_cell(cfg: ModelConfig, shape_name: str, mesh: Mesh, *, fsdp: bool = True,
                n_microbatches: Optional[int] = None, batch_rows: Optional[int] = None,
                dmesh=None):
    if cfg.attn_impl != "ref":
        raise ValueError(f"the dry run counts attn_impl='ref' cells; {cfg.name} has "
                         f"attn_impl={cfg.attn_impl!r}, whose kernels launch out of "
                         f"the op counter's sight")
    shape = SHAPES[shape_name]

    if shape.kind == "train":
        params = registry.init_params(cfg, device=META)
        with shlib.use_mesh(mesh):
            pspecs = registry.param_specs(cfg)
            if fsdp:
                pspecs = shlib.fsdp_specs(pspecs, params)
            ospecs = opt.opt_specs(pspecs, params)
        opt_state = opt.adamw_init(params)
        batch, bspecs = _batch(cfg, shape, train=True, rows=batch_rows)
        n_micro = n_microbatches or default_microbatches(cfg, shape, mesh)
        tcfg = TrainConfig(n_microbatches=n_micro)

        def fn(params, opt_state, b):
            with shlib.use_mesh(mesh):
                return train_step(cfg, tcfg, params, opt_state, b)

        args = (params, opt_state, batch)
        logical = (pspecs, ospecs, bspecs)
        donate = (0, 1)
    else:
        scfg = serving_config(cfg, shape.kind)
        params = registry.init_params(scfg, device=META)
        b = batch_rows or shape.global_batch
        cache = registry.init_cache(scfg, b, shape.seq_len, device=META)
        with shlib.use_mesh(mesh):
            pspecs = registry.param_specs(scfg)
            cspecs = registry.cache_specs(scfg)
        if shape.kind == "prefill":
            batch, bspecs = _batch(scfg, shape, train=False, rows=batch_rows)

            def fn(params, cache, bt):
                with shlib.use_mesh(mesh):
                    return registry.prefill(scfg, params, cache, bt)

            args = (params, cache, batch)
            logical = (pspecs, cspecs, bspecs)
        else:
            tokens = torch.empty((b, 1), dtype=torch.int32, device=META)
            pos = torch.empty((b,), dtype=torch.int32, device=META)

            def fn(params, cache, tok, p):
                with shlib.use_mesh(mesh):
                    return registry.decode_step(scfg, params, cache, tok, p)

            args = (params, cache, tokens, pos)
            logical = (pspecs, cspecs, ("batch", None), ("batch",))
        n_micro = 1
        donate = (1,)

    phys = tuple(_physical(a, sp, mesh) for a, sp in zip(args, logical))
    placements = tuple(shlib.tree_map_specs(lambda sp: shlib.placements(sp, mesh), p)
                       for p in phys)
    cell = Cell(fn, shape.kind, phys, placements, n_micro)
    if dmesh is not None:
        args = tuple(shlib.distribute_tree(a, sp, dmesh) for a, sp in zip(args, logical))
    return cell, args, donate


def input_specs(arch_cfg: ModelConfig, shape_name: str, mesh: Mesh):
    """The stand-ins of every input of a cell: a tree of :class:`StandIn`
    (global shape, dtype, placements) of the arguments' structure."""
    cell, args, _ = build_cell(arch_cfg, shape_name, mesh)
    return tuple(shlib.tree_map_specs(lambda pl, t: StandIn(tuple(t.shape), t.dtype, pl), p, a)
                 for a, p in zip(args, cell.placements))


def argument_bytes(cell: Cell, args, mesh: Mesh) -> int:
    """Bytes of the arguments a device holds: each leaf's local shard under
    its physical spec on ``mesh`` (``sharding.local_shape``), summed."""
    return sum(math.prod(shlib.local_shape(t.shape, sp, mesh)) * t.element_size()
               for a, specs in zip(args, cell.specs)
               for t, sp in zip(registry.leaves(a), _spec_leaves(specs)))


def _spec_leaves(tree) -> list:
    if tree is None or isinstance(tree, tuple):
        return [tree or ()]
    items = tree.values() if isinstance(tree, dict) else tree
    return [s for item in items for s in _spec_leaves(item)]
