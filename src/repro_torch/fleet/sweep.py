"""Batched policy-parameter sweeps over the chunked fluid simulator.

The oracle explores a trade-off frontier (Fig. 8 / Fig. 10) by re-running a
discrete-event simulation per configuration — minutes per point.  Here the
whole grid runs as ONE chunked run over a leading point axis of the
policy/fleet parameters of ``repro_torch.core.simtorch``: every (keepalive x
warm-pool x node-cap x target) combination shares each tick's launches, so
a hundred-point frontier costs little more than one simulation.

    rows = sweep(trace, JaxPolicy(kind=0), JaxFleet(),
                 grid={"keepalive_s": [60, 300, 600],
                       "warm_frac": [0.0, 0.25, 0.5],
                       "max_nodes": [8, 16]}, device="cuda")

Each row carries the swept parameters, the standard summary metrics, and
the dollar bill (cost_per_million) from ``repro_torch.fleet.billing`` — pass
``billing="aws_lambda"`` / ``"gcr"`` to bill the whole grid through a
provider-calibrated profile (default: the ``ideal`` profile, bitwise the
old ``repro_torch.fleet.costs`` math).

This module is the stable fleet-facing surface; the machinery itself lives
in ``repro_torch.opt`` (``opt.search.evaluate_points`` generalizes it so
EVERY policy axis a registered ``repro_torch.core.policy_api`` family
declares sweepable — keepalive, utilization target, container concurrency,
pre-warm lead, and whatever future families declare — is a batch axis,
which is what the frontier engine sweeps).  ``grid_points`` /
``pareto_front`` / ``SWEEPABLE`` live at their canonical homes in
``repro_torch.opt``.

The port of ``repro.fleet.sweep``; as there, ``repro_torch.fleet`` does not
import it.  The sweep runs on ``device`` (CUDA by default, raising without
it; the CPU only when named).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from repro_torch.core.eventsim import SimConfig
from repro_torch.core.simtorch import JaxFleet, JaxPolicy
from repro_torch.core.trace import Trace
from repro_torch.fleet.billing import BillingProfile
from repro_torch.fleet.nodes import NodeType
from repro_torch.opt.search import evaluate_points


def sweep(trace: Trace, policy: JaxPolicy, fleet: JaxFleet,
          grid: Optional[dict] = None, points: Optional[Sequence[dict]] = None,
          sim: SimConfig = SimConfig(), dt: float = 1.0,
          node_type: Optional[NodeType] = None,
          billing: Union[str, BillingProfile, None] = None,
          warmup_frac: float = 0.5, chunk_ticks: int = 512,
          devices: int = 0, *, device=None) -> list[dict]:
    """Run every parameter point through one batched chunked run on
    ``device``; return one row per point: {params..., metrics..., cost
    fields...}."""
    from repro_torch.opt.space import grid_points as _grid_points
    pts = list(points) if points is not None else _grid_points(grid or {})
    return evaluate_points(trace, policy, fleet, pts, sim=sim, dt=dt,
                           node_type=node_type, billing=billing,
                           warmup_frac=warmup_frac, chunk_ticks=chunk_ticks,
                           devices=devices, device=device)
