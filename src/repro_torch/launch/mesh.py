"""Production meshes.

The port of ``repro.launch.mesh``.  Defined as functions (never
module-level constants) so importing this module touches no device state.
The production meshes are descriptions only (named axes and sizes, no
devices): the port runs on no 256-card machine, and what reads them is the
spec arithmetic of ``repro_torch.distributed.sharding``.
"""

from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh(device=None) -> Mesh:
    """Degenerate 1x1 mesh on the current CUDA device (raises without one),
    or on the CPU with ``device="cpu"`` (for smoke/e2e runs)."""
    return Mesh(("data", "model"), (1, 1), (resolve_device(device),))
