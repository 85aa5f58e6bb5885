"""Fluid multi-cell engine: a cell axis in the chunked run.

The port of ``repro.cells.fluid``.  The step math is the plain engine's,
literally: every tick each cell advances through ``simtorch._make_step``.
Where JAX vmaps the step over a leading cell axis, the port folds the cells
into the step's point axis: one row a (point, cell), P·C rows, row
``p * C + c``.  The per-cell inputs (mean arrival rate, gap statistics,
static nodes) carry that row axis, and each tick the step takes its routed
(P·C, F) arrivals and, where triggers or a failure move them, its fleet
bounds.  The cells layer wraps it:

* the ROUTER: incoming per-cell arrivals are redistributed through a
  (C, C) row-stochastic flux matrix (``repro_torch.cells.traffic``) — spill
  overflow to warm siblings, dead-cell traffic to the failover
  distribution.  ``route_skew`` and ``spill_threshold`` come from the
  policy params when the family declares them (a (P, 1) knob each), from
  the topology otherwise.  The routed arrivals are summed over origin
  cells in cell order, not by a matrix product, so every device adds in
  the same order.
* FAILOVER: at the (static) failure tick the dying cell's queued and
  in-flight mass re-queues on survivors along the failover distribution;
  from then on its state is alive-masked to zero and its fleet bounds
  collapse to (0, 0), so the dead region bills nothing and contributes
  nothing to the metric sums.  Which cells are alive depends on the tick
  alone, so the masks are made on the host, as the plain engine's window
  slot and warm-up mask are.
* TRIGGERS: host-precomputed scheduled floors (a (T, C) matrix) and
  reactive threshold floors (latches on the device) raise each cell's
  fleet ``min_nodes`` inside the step — the fluid lowering of
  ``ConvergenceFleetPolicy``.

Accumulation mirrors the plain ``_chunk_impl``: one (F, nbins) delay
histogram a point summed ACROSS cells (function ids share one id space),
the 11 scalar sums cell-summed, the measured-tick counter bumped once a
tick, plus per-cell partial sums for the attribution detail
(``cell_rows``).  The cells' histogram adds go in one ``scatter_add_`` a
cell, in cell order, so no two adds of one call meet in a histogram cell
and the result is deterministic on the card.  A healthy one-cell topology
runs the plain engine's operations on the same values: its row equals
``simulate_chunked``'s bit for bit.  Nothing in the tick loop reads a
tensor back to the host.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.cells.topology import CellTopology
from repro_torch.cells.traffic import failover_dist, flux_matrix, spill_fraction
from repro_torch.core.policy_api import get_family
from repro_torch.core.simtorch import (_ACC_NAMES, _PFLEET, F32, _acc_summary,
                                       _arrivals_on, _billed_weights, _delay_edges,
                                       _init_state, _make_step, _params_to,
                                       _prep_static, _upload, stack_params)
from repro_torch.core.trace import gap_statistics, rate_matrix
from repro_torch.device import resolve_device


def _rows(x: torch.Tensor, points: int) -> torch.Tensor:
    """A per-cell (C, ...) tensor as one row a (point, cell): (P·C, ...)."""
    return x.repeat(points, *([1] * (x.dim() - 1)))


def _point_rows(tree, cells: int):
    """A params tree (or tensor) with a leading point axis, each point
    repeated once a cell: (P, ...) -> (P·C, ...)."""
    if isinstance(tree, dict):
        return {k: _point_rows(v, cells) for k, v in tree.items()}
    return tree.repeat_interleave(cells, dim=0)


def _cell_sum(y: torch.Tensor, alive: np.ndarray) -> torch.Tensor:
    """The sum over the alive cells of a (P, C, ...) tensor, in cell order
    (a dead cell's zero share is left out: it would add zeros); zeros once
    no cell is alive."""
    live = [c for c in range(y.shape[1]) if alive[c] > 0.0]
    if not live:
        return torch.zeros_like(y[:, 0])
    out = y[:, live[0]]
    for c in live[1:]:
        out = out + y[:, c]
    return out


def _route(flux: torch.Tensor, a_t: torch.Tensor) -> torch.Tensor:
    """Routed arrivals (P, C, F) = sum over origin cells c of
    flux[p, c, d] * a_t[c, f], added in cell order."""
    out = flux[:, 0, :, None] * a_t[0]
    for c in range(1, a_t.shape[0]):
        out = out + flux[:, c, :, None] * a_t[c]
    return out


def _cells_chunk_impl(state, arr_chunk, tick0: int, *, floor, lam0, gaps, gap_tab,
                      dur, mem, billed_w, pol, fleet, trig, cpu_consts, static_nodes,
                      edges, points: int, warm_tick: int, total_ticks: int, family: str,
                      dt: float, cold_ticks: int, wbuf: int, prov_ticks: int,
                      has_fleet: bool, fail_cell: int, fail_tick: int, rs, thr):
    """One time chunk of the C-cell run for every point.

    ``state`` is ``(st, fr, ft, tcool)``: the engine state with P·C rows
    plus the reactive-trigger latches (held floor / expiry tick / re-arm
    tick, each (P, C, K)); ``arr_chunk`` is (T_c, C, F) and ``tick0`` the
    Python int of its first tick; ``floor`` the (T, C) scheduled floors on
    the device (None without schedule); ``trig`` the (K,) trigger constants
    (util_high, change, hold_ticks, cool_ticks) or None.  Returns the state
    and this chunk's float32 partials: hist (P, F, nbins), arrtot (P, F),
    sums (P, 11), n (host int), csums (P, C, 11), cn (C,) host numpy."""
    c_n, f = arr_chunk.shape[1], arr_chunk.shape[2]
    rows = points * c_n
    dev = arr_chunk.device
    nbins = edges.shape[0] + 1
    n_acc = len(_ACC_NAMES)
    has_reactive = trig is not None
    step = _make_step(None, dur, mem, billed_w, lam0, gaps, gap_tab, pol, fleet,
                      cpu_consts, static_nodes, family=family, dt=dt,
                      cold_ticks=cold_ticks, wbuf=wbuf, prov_ticks=prov_ticks,
                      has_fleet=has_fleet)
    all_alive = np.ones(c_n)
    dead_alive = all_alive.copy()
    if fail_cell >= 0:
        dead_alive[fail_cell] = 0.0
    alive_dead_t = torch.as_tensor(dead_alive, dtype=F32, device=dev)      # (C,)
    alive_dead_rows = _rows(alive_dead_t, points)                          # (P·C,)
    ones_t = torch.ones(c_n, dtype=F32, device=dev)
    cc_rows = pol["cc"]                                                    # (P·C, 1)
    fleet_min = fleet[:, 0:1].reshape(points, c_n)
    fleet_max = fleet[:, 1:2].reshape(points, c_n)
    moves_bounds = has_fleet and (floor is not None or has_reactive or fail_cell >= 0)

    def mask_state(st):
        # a dead cell's rows of every tensor leaf to zero (the window
        # cursor is a Python int of the tick: no row of its own)
        return tuple(x if not isinstance(x, torch.Tensor) else
                     x * alive_dead_rows.view((rows,) + (1,) * (x.dim() - 1))
                     for x in st)

    st, fr, ft, tcool = state
    hist = torch.zeros(points, f, nbins, dtype=F32, device=dev)
    arrtot = torch.zeros(points, f, dtype=F32, device=dev)
    sums = torch.zeros(points, n_acc, dtype=F32, device=dev)
    csums = torch.zeros(points, c_n, n_acc, dtype=F32, device=dev)
    cn = np.zeros(c_n)
    n = 0
    # the failover distribution (P, C) before and after the failure: which
    # cells are alive depends on the tick alone
    fail_all, fail_dead = failover_dist(ones_t, rs), failover_dist(alive_dead_t, rs)
    for i in range(arr_chunk.shape[0]):
        g = tick0 + i
        dead = 0 <= fail_cell and g >= fail_tick
        alive_np = dead_alive if dead else all_alive
        alive_t = alive_dead_t if dead else ones_t
        a_t = arr_chunk[i]                                                 # (C, F)
        moved = None
        if dead:
            if g == fail_tick:
                # failover: harvest the dying cell's backlog + in-flight
                # mass BEFORE masking and re-inject it on survivors as
                # retry ARRIVALS at the failure tick (see repro.cells.fluid)
                moved = (st[1] + st[2]).view(points, c_n, f)[:, fail_cell]
            st = mask_state(st)
        # the router reads the previous tick's (masked) state
        fail_d = fail_dead if dead else fail_all
        slots = (st[0].sum(-1, keepdim=True) * cc_rows).view(points, c_n)
        free = torch.clamp_min(slots - st[1].sum(-1).view(points, c_n), 0.0)
        s = spill_fraction(st[2].sum(-1).view(points, c_n), a_t.sum(-1), slots,
                           thr) * alive_t
        routed = _route(flux_matrix(alive_t, s, free, fail_d), a_t)
        if moved is not None:
            routed = routed + fail_d[:, :, None] * moved[:, None, :]
        routed = routed.reshape(rows, f)

        bounds = None
        if moves_bounds:
            lo = fleet_min if floor is None else torch.maximum(fleet_min, floor[g])
            if has_reactive:
                lo = torch.maximum(lo, torch.where(ft > g, fr, 0.0).amax(-1))
            hi = fleet_max
            if dead:
                lo, hi = lo * alive_t, hi * alive_t
            bounds = (lo.reshape(rows, 1), hi.reshape(rows, 1))
        st, ys = step(st, g, arr=routed, bounds=bounds)

        # reactive triggers read this tick's utilization; the raised floor
        # binds from the NEXT tick (a one-tick actuation lag, matching the
        # oracle's once-per-tick reconcile)
        if has_reactive and has_fleet:
            util_high, change, hold_ticks, cool_ticks = trig
            util = (ys[4] / torch.clamp_min(ys[10] * fleet[:, 5:6], 1e-9)).view(points, c_n, 1)
            can = (util >= util_high) & (tcool <= g) & (alive_t[:, None] > 0.0)
            fr = torch.where(can, ys[10].view(points, c_n, 1) + change, fr)
            ft = torch.where(can, g + hold_ticks, ft)
            tcool = torch.where(can, g + cool_ticks, tcool)

        if not warm_tick <= g < total_ticks:
            continue
        # accumulate: histogram mass per function over the alive cells in
        # cell order, scalars cell-summed, n bumped ONCE per tick
        delay, arr, arr_delayed = ys[0], ys[1], ys[2]
        b = torch.clamp(torch.searchsorted(edges, delay, right=True), 0, nbins - 1)
        b3, ad3 = b.view(points, c_n, f), arr_delayed.view(points, c_n, f)
        hflat = hist.view(points * f, nbins)
        for c in range(c_n):
            if alive_np[c] > 0.0:
                hflat.scatter_add_(1, b3[:, c].reshape(-1, 1), ad3[:, c].reshape(-1, 1))
        arr3 = arr.view(points, c_n, f)
        hist[..., 0] += _cell_sum(arr3 - ad3, alive_np)
        arrtot = arrtot + _cell_sum(arr3, alive_np)
        y = torch.cat(ys[3:3 + n_acc], 1).view(points, c_n, n_acc)
        sums = sums + _cell_sum(y, alive_np)
        csums = csums + (y * alive_t[:, None] if dead else y)
        cn += alive_np
        n += 1
    return (st, fr, ft, tcool), (hist, arrtot, sums, n, csums, cn)


@dataclasses.dataclass
class _CellsRun:
    """A cells run's inputs on the device: the (T, C, F) arrivals, the
    initial state, and the keyword arguments of every ``_cells_chunk_impl``
    call but the state, the chunk and its first tick."""
    arr: torch.Tensor
    state: tuple
    chunk_kw: dict
    n_ticks: int
    chunk_ticks: int


def _cells_setup(traces, topo: CellTopology, policy, pols, fleets, *, sim, dt: float,
                 num_nodes: int, provision_s: float, has_fleet: bool, chunk_ticks: int,
                 warmup_frac: float, nbins: int, billing=None, device=None) -> _CellsRun:
    """The host preparation of ``cells_chunked_summaries`` (the per-cell rate
    matrices and gap statistics, the static vectors, the trigger tables) and
    its one upload."""
    c_n = topo.cell_count
    if len(traces) != c_n:
        raise ValueError(f"got {len(traces)} cell traces for a "
                         f"{c_n}-cell topology")
    if (topo.scheduled or topo.reactive) and not has_fleet:
        raise ValueError("cell triggers drive the node fleet: the scenario "
                         "needs a fleet for scheduled/reactive triggers")
    dev = resolve_device(device)
    mats = [np.asarray(rate_matrix(tr, dt)) for tr in traces]
    arr_np = np.stack(mats, axis=1)                     # (T, C, F)
    n_ticks, _, f = arr_np.shape
    duration_s = traces[0].duration_s
    dur, mem, cold_ticks, wbuf, cpu_consts = _prep_static(traces[0], policy, sim, dt)
    billed_w = _billed_weights(traces[0], billing)      # profile-wide
    prov_ticks = max(1, int(round(provision_s / dt)))
    n_points = fleets.shape[0]

    lam0 = _upload(np.stack([m.mean(axis=0) / dt for m in mats]), dev)   # (C, F)
    gq_l, at_l, tt_l = zip(*(gap_statistics(tr) for tr in traces))
    ft_s = topo.fail_time(duration_s)
    fail_tick = -1 if ft_s is None else int(round(ft_s / dt))
    floor = None
    if topo.scheduled:
        floor = _upload(topo.floor_schedule(n_ticks, dt, duration_s), dev)   # (T, C)
    trig = None
    k = len(topo.reactive)
    if k:
        trig = tuple(_upload(v, dev) for v in (
            [t.util_high for t in topo.reactive], [t.change for t in topo.reactive],
            [max(1, round(t.hold_s / dt)) for t in topo.reactive],
            [max(1, round(t.cooldown_s / dt)) for t in topo.reactive]))
    # traced router knobs when the family declares them, topology statics
    # otherwise (a non-cells policy family can still run a topology)
    pol_p = _params_to(pols, dev)

    def knob(name):                                     # (P, 1)
        if name in pol_p:
            return pol_p[name]
        return torch.full((n_points, 1), float(getattr(topo, name)), dtype=F32, device=dev)
    fleets_t = _upload(fleets, dev)
    fleet_rows = _point_rows(fleets_t, c_n)
    static_rows = _rows(_upload(topo.cell_nodes(num_nodes), dev), n_points)[:, None]
    init_nodes = fleet_rows[:, :1] if has_fleet else static_rows
    st = _init_state(f, cold_ticks, wbuf, prov_ticks, init_nodes,
                     points=n_points * c_n, device=dev)
    latch = torch.zeros(n_points, c_n, k, dtype=F32, device=dev)
    chunk_kw = dict(
        floor=floor, lam0=_rows(lam0, n_points),
        gaps=_rows(_upload(np.stack(gq_l), dev), n_points),
        gap_tab=(_rows(_upload(np.stack(at_l), dev), n_points),
                 _rows(_upload(np.stack(tt_l), dev), n_points)),
        dur=_upload(dur, dev), mem=_upload(mem, dev), billed_w=_upload(billed_w, dev),
        pol=_point_rows(pol_p, c_n), fleet=fleet_rows, trig=trig, cpu_consts=cpu_consts,
        static_nodes=static_rows, edges=torch.as_tensor(_delay_edges(nbins), device=dev),
        points=n_points, warm_tick=int(n_ticks * warmup_frac), total_ticks=n_ticks,
        family=policy.family, dt=dt, cold_ticks=cold_ticks, wbuf=wbuf,
        prov_ticks=prov_ticks, has_fleet=has_fleet, fail_cell=int(topo.fail_cell),
        fail_tick=fail_tick, rs=knob("route_skew"), thr=knob("spill_threshold"))
    return _CellsRun(arr=_arrivals_on(arr_np, dev),
                     state=(st, latch, latch.clone(), latch.clone()), chunk_kw=chunk_kw,
                     n_ticks=n_ticks, chunk_ticks=max(1, min(chunk_ticks, n_ticks)))


def cells_chunked_summaries(traces, topo: CellTopology, policy, pols, fleets, *, sim,
                            dt: float, num_nodes: int, provision_s: float,
                            has_fleet: bool, chunk_ticks: int, warmup_frac: float = 0.5,
                            nbins: int = 256, billing=None,
                            detail: Optional[dict] = None, device=None) -> list:
    """Run a batch of policy/fleet points through the C-cell chunked loop
    and return one ``summarize``-style row per point (the multi-cell twin
    of ``simtorch._chunked_summaries``; same metric keys, cross-cell sums).

    ``traces`` is the per-cell partition from ``build_cell_traces`` (one
    ``Trace`` per cell over the SHARED function id space).  When ``detail``
    is a dict it receives ``cell_rows`` — point 0's per-cell attribution
    partials (node-seconds, churn CPU, completions per cell).  The run
    happens on ``device`` (CUDA by default)."""
    run = _cells_setup(traces, topo, policy, pols, fleets, sim=sim, dt=dt,
                       num_nodes=num_nodes, provision_s=provision_s, has_fleet=has_fleet,
                       chunk_ticks=chunk_ticks, warmup_frac=warmup_frac, nbins=nbins,
                       billing=billing, device=device)
    c_n, n_points, f = topo.cell_count, fleets.shape[0], run.arr.shape[2]
    f64 = dict(dtype=torch.float64, device=run.arr.device)
    hist = torch.zeros(n_points, f, nbins, **f64)
    arrtot = torch.zeros(n_points, f, **f64)
    sums = torch.zeros(n_points, len(_ACC_NAMES), **f64)
    csums = torch.zeros(n_points, c_n, len(_ACC_NAMES), **f64)
    n, cn = 0.0, np.zeros(c_n)
    state = run.state
    # as the plain engine, the last chunk ends at the last tick (JAX pads it
    # with masked ticks that add nothing)
    with torch.no_grad():
        for t0 in range(0, run.n_ticks, run.chunk_ticks):
            state, out = _cells_chunk_impl(state, run.arr[t0:t0 + run.chunk_ticks], t0,
                                           **run.chunk_kw)
            hist += out[0]
            arrtot += out[1]
            sums += out[2]
            n += out[3]
            csums += out[4]
            cn += out[5]
    iid = get_family(policy.family).synchronous_tail
    edges = _delay_edges(nbins)
    dur_median = np.asarray(traces[0].profile.dur_median)
    dur_sigma = np.asarray(traces[0].profile.dur_sigma)
    hist, arrtot = hist.cpu().numpy(), arrtot.cpu().numpy()
    sums, csums = sums.cpu().numpy(), csums.cpu().numpy()

    def row(i):
        return _acc_summary(hist[i], arrtot[i], sums[i], n, edges, dur_median,
                            dur_sigma, sim.warm_latency_s, dt, iid_tail=iid)
    with ThreadPoolExecutor(min(n_points, os.cpu_count() or 1)) as pool:
        rows = list(pool.map(row, range(n_points)))
    if detail is not None:
        detail["cell_rows"] = _cell_rows(csums[0], cn, dt)
    return rows


def _cell_rows(csums, cn, dt: float) -> list:
    """Per-cell attribution partials (point 0): where the node-seconds and
    churn CPU of a multi-region run actually accrue — the cells extension
    of the overhead-attribution ledger."""
    out = []
    for c in range(csums.shape[0]):
        s = dict(zip(_ACC_NAMES, csums[c]))
        ticks = max(float(cn[c]), 1e-9)
        out.append({
            "cell": c,
            "ticks_alive": float(cn[c]),
            "instances_mean": float(s["instances"] / ticks),
            "nodes_mean": float(s["nodes"] / ticks),
            "node_seconds": float(s["nodes"] * dt),
            "spot_node_seconds": float(s["spot_nodes"] * dt),
            "creations": float(s["creations"]),
            "completed": float(s["completions"]),
            "cpu_worker_s": float(s["cpu_worker"]),
            "cpu_master_s": float(s["cpu_master"]),
            "cpu_useful_s": float(s["useful"]),
            "billed_gb_s": float(s["billed_gb_s"]),
            "mem_total_mean": float(s["mem_total"] / ticks),
        })
    return out


def run_cells_fluid(sc, traces, sim, *, billing=None, detail: Optional[dict] = None,
                    device=None) -> dict:
    """Single-point fluid replay of a cells scenario (the runner's simjax
    leg) on ``device`` (CUDA by default).  Returns one
    ``simulate_chunked``-style metric row."""
    policy = sc.policy.to_jax()
    has_fleet = sc.fleet is not None
    pols = stack_params([policy.params()])
    fleets = np.asarray([sc.fleet.params() if has_fleet
                         else np.zeros(len(_PFLEET))], np.float32)
    return cells_chunked_summaries(
        traces, sc.cells, policy, pols, fleets, sim=sim, dt=sim.tick_s,
        num_nodes=sc.num_nodes,
        provision_s=sc.fleet.provision_s if has_fleet else 0.0,
        has_fleet=has_fleet, chunk_ticks=sc.chunk_ticks,
        billing=billing, detail=detail, device=device)[0]
