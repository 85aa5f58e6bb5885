"""Dollar-cost accounting: node-hours + control-plane CPU -> $/1M requests.

A copy of ``repro.fleet.costs`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

The paper's metrics (CPU churn overhead, memory over-allocation, creation
rate) are resource-denominated; operators optimize dollars ("Understanding
Cost Dynamics of Serverless Computing", PAPERS.md).  This module converts a
simulation's resource totals into a bill:

* worker fleet:   billable node-seconds x the node type's $/hour,
* control plane:  master CPU-seconds x a managed-vCPU rate (apiserver,
  autoscaler, activator — billed per-vCPU like a managed control plane),
* attribution:    the share of the worker bill burned by churn
  (create/teardown CPU) and by idle keepalive memory, so the headline
  "cost of keeping warm" is a dollar figure.

Pricing defaults are in the table in EXPERIMENTS.md.
"""

from __future__ import annotations

import dataclasses

from repro_torch.fleet.nodes import NodeType


@dataclasses.dataclass(frozen=True)
class PriceBook:
    master_vcpu_per_hour: float = 0.048   # managed control-plane vCPU $/h
    # spot-tier discount: 0.65 -> SPOT node-hours bill at 35% of on-demand.
    # Applied ONLY to the ``spot_node_seconds`` share of the fleet — a
    # mixed fleet bills each tier at its own rate (it used to be applied
    # fleet-wide, which overstated the savings of any partial-spot fleet).
    spot_discount: float = 0.0


@dataclasses.dataclass
class CostReport:
    node_hours: float
    node_cost: float                 # worker fleet bill
    master_cpu_hours: float
    master_cost: float               # control-plane bill
    churn_cost: float                # share of node bill spent creating/tearing down
    idle_cost: float                 # share of node bill holding idle-warm instances
    total_cost: float
    completed: int
    cost_per_million: float          # $ / 1M completed requests

    def row(self) -> dict:
        return dataclasses.asdict(self)


def cost_report(*, node_seconds: float, cpu_worker_overhead_s: float,
                cpu_master_overhead_s: float, idle_node_share: float,
                completed: int, node_type: NodeType = NodeType(),
                prices: PriceBook = PriceBook(),
                spot_node_seconds: float = 0.0) -> CostReport:
    """``idle_node_share``: fraction of fleet capacity held by idle-warm
    instances (e.g. ``(mem_total - mem_busy) / fleet capacity`` averaged
    over the measurement window).  ``spot_node_seconds`` is the share of
    ``node_seconds`` billed on the spot tier (at ``1 - spot_discount`` of
    the on-demand rate); billing is per tier, never fleet-wide."""
    node_hours = node_seconds / 3600.0
    od_rate = node_type.price_per_hour
    spot_rate = od_rate * (1.0 - prices.spot_discount)
    spot_hours = min(max(spot_node_seconds, 0.0), node_seconds) / 3600.0
    node_cost = (node_hours - spot_hours) * od_rate + spot_hours * spot_rate

    # churn CPU runs on the workers: price it at the per-vCPU slice of the
    # fleet's BLENDED rate (a mixed fleet churns on both tiers).
    blended_rate = node_cost / node_hours if node_hours > 0.0 else od_rate
    churn_cost = (cpu_worker_overhead_s / 3600.0) \
        * (blended_rate / node_type.vcpus)
    idle_cost = node_cost * max(0.0, min(1.0, idle_node_share))

    master_cpu_hours = cpu_master_overhead_s / 3600.0
    master_cost = master_cpu_hours * prices.master_vcpu_per_hour

    total = node_cost + master_cost
    # a window that completed nothing has no meaningful unit cost: report
    # NaN — labeled, like the ``dropped`` column in ``Metrics.row()`` —
    # instead of a real-looking $/1M figure divided by a phantom request
    per_million = total / completed * 1e6 if completed > 0 else float("nan")
    return CostReport(node_hours, node_cost, master_cpu_hours, master_cost,
                      churn_cost, idle_cost, total, completed, per_million)


def cost_from_sim(result, node_type: NodeType = NodeType(),
                  prices: PriceBook = PriceBook()) -> CostReport:
    """Bill an ``EventSim`` result (fleet-enabled or static-cluster)."""
    node_seconds = result.node_seconds
    if node_seconds <= 0.0 and len(result.sample_times):
        # static cluster: every configured node bills for the whole window
        node_seconds = result.measure_window_s * max(result.nodes_hint, 1)
    cap_mb = max(node_seconds / max(result.measure_window_s, 1e-9), 1e-9) \
        * node_type.memory_mb
    idle_mb = 0.0
    if len(result.mem_samples_total_mb):
        idle_mb = float(result.mem_samples_total_mb.mean()
                        - result.mem_samples_busy_mb.mean())
    return cost_report(
        node_seconds=node_seconds,
        cpu_worker_overhead_s=result.cpu_worker_overhead_s,
        cpu_master_overhead_s=result.cpu_master_overhead_s,
        idle_node_share=idle_mb / cap_mb,
        completed=len(result.records),
        node_type=node_type, prices=prices,
        spot_node_seconds=result.spot_node_seconds)
