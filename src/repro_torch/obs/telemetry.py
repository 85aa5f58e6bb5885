"""In-scan telemetry schema + host-side assembly and export.

A copy of ``repro.obs.telemetry`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

The chunked ``lax.scan`` cannot emit per-tick histories at fig9 scale
(that is the point of the chunked path), so telemetry rides the scan carry
as a BOUNDED downsampled buffer: ``telemetry=S`` slots, each accumulating
sum+tick-count for ~``total_ticks/S`` consecutive ticks, plus a vector of
measurement-window attribution sums — constant memory in trace length.
``repro_torch.core.simtorch`` owns the in-scan side; this module pins the schema
(series order = the ``jnp.stack`` order in ``_make_step``) and turns the
accumulated buffers into timeline CSVs.

``RunTelemetry`` is the host-side event log the opt layer hooks feed
(per-round hypervolume, spot-check demotions, training-loss series): a
flat append-only list of {"event": kind, ...} records, exportable as JSON.
"""

from __future__ import annotations

import csv
import json

import numpy as np

# per-slot downsampled series, in the exact order the scan stacks them
# (repro_torch.core.simtorch._make_step, telem branch)
TELEM_SERIES = ("instances", "busy_instances", "queue_depth", "creations",
                "evictions", "mem_total_mb", "mem_busy_mb",
                "mem_pipeline_mb", "nodes", "spot_nodes", "cpu_worker_s",
                "cpu_master_s")

# measurement-window attribution sums, in scan stack order
TELEM_ATTR = ("cpu_creation_s", "cpu_eviction_s", "cpu_keepalive_s",
              "mem_pipeline_mb_ticks", "evict_kills", "evict_recreates")


def assemble_telemetry(series_sums: np.ndarray, slot_ticks: np.ndarray,
                       attr_sums: np.ndarray, total_ticks: int,
                       dt: float) -> dict:
    """Host-side assembly of the scan's telemetry buffers into the
    ``telemetry`` dict a ``simulate_chunked`` row carries:
    ``series_sums`` is (S, len(TELEM_SERIES)) per-slot sums, ``slot_ticks``
    the (S,) tick counts, ``attr_sums`` the (len(TELEM_ATTR),) sums."""
    series_sums = np.asarray(series_sums, np.float64)
    slot_ticks = np.asarray(slot_ticks, np.float64)
    slots = len(slot_ticks)
    denom = np.maximum(slot_ticks, 1e-9)[:, None]
    means = series_sums / denom
    centers = (np.arange(slots) + 0.5) * (total_ticks / slots) * dt
    return {
        "slots": slots,
        "dt": dt,
        "t": centers,
        "ticks_per_slot": slot_ticks,
        "series": {name: means[:, i] for i, name in enumerate(TELEM_SERIES)},
        "attribution": {name: float(attr_sums[i])
                        for i, name in enumerate(TELEM_ATTR)},
    }


def write_timeline_csv(telemetry: dict, path: str) -> None:
    """One row per slot: slot-center time, ticks covered, then every
    downsampled series (per-tick means over the slot)."""
    names = [n for n in TELEM_SERIES if n in telemetry["series"]]
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["t_s", "ticks"] + names)
        t = telemetry["t"]
        ticks = telemetry["ticks_per_slot"]
        for i in range(telemetry["slots"]):
            w.writerow([f"{t[i]:.6g}", f"{ticks[i]:g}"]
                       + [f"{telemetry['series'][n][i]:.6g}" for n in names])


def write_oracle_timeline_csv(result, path: str) -> None:
    """The oracle's per-tick samples as a timeline CSV (same spirit as the
    fluid one; the oracle samples only inside the measurement window)."""
    t = np.asarray(result.sample_times)
    total = np.asarray(result.mem_samples_total_mb)
    busy = np.asarray(result.mem_samples_busy_mb)
    start = np.asarray(result.mem_samples_starting_mb)
    nodes = np.asarray(result.node_samples)
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["t_s", "mem_total_mb", "mem_busy_mb", "mem_starting_mb",
                    "nodes"])
        for i in range(len(t)):
            w.writerow([f"{t[i]:.6g}", f"{total[i]:.6g}", f"{busy[i]:.6g}",
                        f"{start[i]:.6g}" if i < len(start) else "0",
                        f"{nodes[i]:g}" if i < len(nodes) else ""])


class RunTelemetry:
    """Append-only event log for long-running host loops (frontier search,
    oracle spot-checks, policy training).  Always truthy; callers guard
    with ``if telemetry:`` against the default ``None``."""

    def __init__(self):
        self.events: list[dict] = []

    def emit(self, kind: str, **fields) -> None:
        self.events.append({"event": kind, **fields})

    def series(self, kind: str, field: str) -> list:
        return [e[field] for e in self.events
                if e["event"] == kind and field in e]

    def to_json(self) -> dict:
        return {"events": self.events}

    def write_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2, default=float)
