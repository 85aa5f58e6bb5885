"""The fluid engine's sharded run (``RunSpec(devices=N)``) against the JAX
package's at the same N, on the CPU.

The port lays N shards on the CPU with ``device="cpu"``; JAX's rows come
from one subprocess that sees 8 forced host devices
(``torch_dist_common.jax_jobs``).  On the 61-function trace of
``tests/test_sharding.py`` (prime F, so every N > 1 pads the function axis)
and its ``synthesize_rates`` twin:

* ``devices=1`` is the unsharded port run bit for bit, rows and the
  per-function histograms and arrival totals alike;
* N in {2, 3, 4} holds to JAX's rows at rtol 1e-4 (slowdown 1e-3) and to
  the port's unsharded rows at rtol 1e-5, with the per-function
  histograms and arrival totals the unsharded run's bit for bit;
* with telemetry the slot counts are counted once; a clustered trace pads
  with weight 0;
* the point axis (``evaluate_points`` with a fleet) at 4 points over 2, 3
  (-> 2) and 4 shards, and 3 points over 2 (-> unsharded), as JAX;
* ``fleet.sweep`` and the evo engine take ``devices``; cells refuse
  them; the scenario CLI at ``--devices 2`` prints what
  JAX's prints under two host devices, and the frontier CLI at
  ``--devices 2`` writes its ``--devices 0`` artifacts.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

import repro_torch.core.simtorch as T
import repro_torch.launch.frontier as TFRONTIER
import repro_torch.launch.scenarios as TCLI
from repro_torch.core.runspec import RunSpec as TRunSpec
from repro_torch.fleet.sweep import sweep as t_sweep
from repro_torch.opt import evaluate_points as t_evaluate_points
from repro_torch.opt import frontier_search as t_frontier_search
from repro_torch.scenarios import get_scenario as t_scenario
from repro_torch.scenarios import run_scenario as t_run_scenario
from torch_dist_common import EVENTS61, RATES61, jax_jobs, port_trace
from torch_fluid_common import _hold_row
from torch_opt_common import hold_result
from torch_scenario_common import CLI_RTOL, same_text, without_walls

UNSHARDED_RTOL = 1e-5
FN_RUNS = {
    "events.sync": dict(trace=EVENTS61, policy=dict(kind=0, keepalive_s=120), dt=1.0,
                        num_nodes=8, chunk_ticks=128),
    "rates.async": dict(trace=RATES61, policy=dict(kind=1, window_s=60, target=0.7), dt=2.0,
                        num_nodes=8, chunk_ticks=128),
}
SHARDS = (2, 3, 4)
TELEMETRY = dict(FN_RUNS["events.sync"], spec=dict(devices=3, telemetry=64))


def _cluster_below() -> float:
    """tests/test_sharding.py's threshold: the median function's mean rps."""
    rt = port_trace(RATES61)
    return float(np.median(np.asarray(rt.counts, np.float64).mean(axis=0) / rt.tick_s))


CLUSTERED = dict(FN_RUNS["rates.async"], trace=dict(RATES61, cluster_below=_cluster_below()))
FLEET = dict(node_memory_mb=8192.0)
POINTS4 = [{"keepalive_s": ka} for ka in (60.0, 120.0, 300.0, 600.0)]
POINTS3 = [{"keepalive_s": ka} for ka in (60.0, 300.0, 600.0)]
POINT_RUNS = {f"4pts.d{d}": (POINTS4, d) for d in SHARDS} | {"3pts.d2": (POINTS3, 2)}
SCENARIO_ARGV = ["--scenario", "fig9_planet", "--scale", "0.01", "--engines", "simjax",
                 "--devices", "2"]


def _jobs() -> dict:
    jobs = {f"{name}.d{d}": dict(kind="chunked", fleet=None, spec=dict(devices=d), **run)
            for name, run in FN_RUNS.items() for d in SHARDS}
    jobs["telemetry"] = dict(kind="chunked", fleet=None, **TELEMETRY)
    jobs |= {f"clustered.d{d}": dict(kind="chunked", fleet=None, spec=dict(devices=d),
                                     **CLUSTERED) for d in (2, 3)}
    jobs |= {name: dict(kind="points", trace=EVENTS61, policy=dict(kind=0), fleet=FLEET,
                        points=pts, devices=d, dt=1.0, chunk_ticks=512)
             for name, (pts, d) in POINT_RUNS.items()}
    jobs["cli"] = dict(kind="cli", module="repro.launch.scenarios", argv=SCENARIO_ARGV)
    return jobs


@pytest.fixture(scope="module")
def jax_rows():
    jobs = _jobs()
    return dict(zip(jobs, jax_jobs(list(jobs.values()))))


class _Recorder:
    """Wraps ``simtorch._acc_summary`` to keep each row's per-function
    histogram and arrival totals (as numpy)."""

    def __init__(self, monkeypatch):
        self.seen = []
        inner = T._acc_summary

        def wrapped(hist, arrtot, *a, **kw):
            h = hist.cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
            self.seen.append((h.copy(), np.asarray(arrtot).copy()))
            return inner(hist, arrtot, *a, **kw)
        monkeypatch.setattr(T, "_acc_summary", wrapped)

    def take(self):
        out, self.seen = self.seen, []
        return out


def _port_chunked(run: dict, spec: dict, **kw):
    return T.simulate_chunked(port_trace(run["trace"]), T.JaxPolicy(**run["policy"]),
                              dt=run["dt"], num_nodes=run["num_nodes"],
                              chunk_ticks=run["chunk_ticks"], spec=TRunSpec(**spec),
                              device="cpu", **kw)


def _hold_unsharded(got: dict, base: dict):
    _hold_row(got, base, rtol=UNSHARDED_RTOL, slowdown_rtol=UNSHARDED_RTOL)


def _assert_same_histograms(got, base):
    assert len(got) == len(base)
    for (hg, ag), (hb, ab) in zip(got, base):
        np.testing.assert_array_equal(hg, hb)
        np.testing.assert_array_equal(ag, ab)


@pytest.mark.parametrize("name", list(FN_RUNS))
def test_one_shard_is_the_unsharded_run_bit_for_bit(name, monkeypatch):
    rec = _Recorder(monkeypatch)
    base = _port_chunked(FN_RUNS[name], {})
    base_h = rec.take()
    one = _port_chunked(FN_RUNS[name], dict(devices=1))
    assert one == base
    _assert_same_histograms(rec.take(), base_h)


@pytest.mark.parametrize("devices", SHARDS)
@pytest.mark.parametrize("name", list(FN_RUNS))
def test_function_shards_hold_to_jax_and_the_unsharded_run(name, devices, jax_rows,
                                                            monkeypatch):
    rec = _Recorder(monkeypatch)
    base = _port_chunked(FN_RUNS[name], {})
    base_h = rec.take()
    got = _port_chunked(FN_RUNS[name], dict(devices=devices))
    _hold_row(got, jax_rows[f"{name}.d{devices}"])
    _hold_unsharded(got, base)
    _assert_same_histograms(rec.take(), base_h)


def test_three_shards_divide_the_static_nodes_by_three(jax_rows):
    """nodes_mean at 3 shards: the static node count 8 and the master CPU
    floor are divided by 3, which is not exact in binary; JAX's row reads
    the same few-ulp shortfall (ROADMAP Queue 3)."""
    got = _port_chunked(FN_RUNS["events.sync"], dict(devices=3))
    want = jax_rows["events.sync.d3"]["nodes_mean"]
    assert want != 8.0 and want == pytest.approx(8.0, rel=1e-6)
    assert got["nodes_mean"] == pytest.approx(8.0, rel=1e-6)
    assert _port_chunked(FN_RUNS["events.sync"], dict(devices=4))["nodes_mean"] == 8.0


def test_telemetry_slot_counts_are_counted_once(jax_rows):
    want = jax_rows["telemetry"]
    got = _port_chunked(TELEMETRY, TELEMETRY["spec"])
    base = _port_chunked(TELEMETRY, dict(telemetry=64))
    _hold_row(got, want)
    _hold_unsharded(got, base)
    tg, tw, tb = got["telemetry"], want["telemetry"], base["telemetry"]
    np.testing.assert_array_equal(tg["ticks_per_slot"], tw["ticks_per_slot"])
    np.testing.assert_array_equal(tg["ticks_per_slot"], tb["ticks_per_slot"])
    assert float(np.sum(tg["ticks_per_slot"])) == 900.0
    for k, v in tw["series"].items():
        np.testing.assert_allclose(tg["series"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tg["series"][k], tb["series"][k], rtol=UNSHARDED_RTOL,
                                   atol=1e-6, err_msg=k)
    for k, v in tw["attribution"].items():
        assert tg["attribution"][k] == pytest.approx(v, rel=1e-4, abs=1e-9), k


@pytest.mark.parametrize("devices", (2, 3))
def test_a_clustered_trace_pads_with_weight_zero(devices, jax_rows, monkeypatch):
    trace = port_trace(CLUSTERED["trace"])
    assert trace.num_functions % devices and np.all(trace.weights > 0)
    h = T._host_inputs(trace, T.JaxPolicy(**CLUSTERED["policy"]), T.SimConfig(), 2.0, None,
                       devices)
    pad = (-trace.num_functions) % devices
    np.testing.assert_array_equal(h.fn["weights"][-pad:], 0.0)
    np.testing.assert_array_equal(h.arr[:, -pad:], 0)
    assert h.fn["weights"].shape == (trace.num_functions + pad,)
    rec = _Recorder(monkeypatch)
    base = _port_chunked(CLUSTERED, {})
    base_h = rec.take()
    got = _port_chunked(CLUSTERED, dict(devices=devices))
    _hold_row(got, jax_rows[f"clustered.d{devices}"])
    _hold_unsharded(got, base)
    _assert_same_histograms(rec.take(), base_h)


@pytest.mark.parametrize("name", list(POINT_RUNS))
def test_point_shards_hold_to_jax(name, jax_rows):
    pts, devices = POINT_RUNS[name]
    trace = port_trace(EVENTS61)
    pol, fleet = T.JaxPolicy(kind=0), T.JaxFleet(**FLEET)
    shards, fn_axis = T._shard_plan(len(pts), True, devices, "cpu", None)
    assert not fn_axis and len(shards) == {"4pts.d2": 2, "4pts.d3": 2, "4pts.d4": 4,
                                           "3pts.d2": 1}[name]
    got = t_evaluate_points(trace, pol, fleet, pts, devices=devices, device="cpu")
    base = t_evaluate_points(trace, pol, fleet, pts, device="cpu")
    want = jax_rows[name]
    assert len(got) == len(want) == len(pts)
    for g, w, b in zip(got, want, base):
        _hold_row(g, w)
        if len(shards) == 1:
            assert g == b
        else:
            _hold_unsharded(g, b)


def test_a_mesh_places_the_point_shards(jax_rows):
    """``evaluate_points(mesh=...)``: two shards where the caller puts them
    (both on the CPU here; both on one card in chip_smoke.py)."""
    from repro_torch.distributed.sharding import Mesh
    mesh = Mesh(("points",), (2,), (torch.device("cpu"),) * 2)
    trace = port_trace(EVENTS61)
    got = t_evaluate_points(trace, T.JaxPolicy(kind=0), T.JaxFleet(**FLEET), POINTS4,
                            device="cpu", mesh=mesh)
    for g, w in zip(got, jax_rows["4pts.d2"]):
        _hold_row(g, w)


def test_the_sweep_and_the_evo_engine_take_devices(jax_rows):
    """``fleet.sweep`` at devices=2 gives ``evaluate_points``' rows, held to
    JAX's; the evo engine (``frontier_search(algo="evo")``) at devices=2
    keeps its unsharded run's candidates, rows, fronts and robust ids."""
    got = t_sweep(port_trace(EVENTS61), T.JaxPolicy(kind=0), T.JaxFleet(**FLEET),
                  points=POINTS4, devices=2, device="cpu")
    for g, w in zip(got, jax_rows["4pts.d2"]):
        _hold_row(g, w)
    kw = dict(scale=0.1, coarse_frac=1.0, algo="evo", budget=16, seed=0, device="cpu")
    base = t_frontier_search(["fleet_cost_stress"], **kw)
    sharded = t_frontier_search(["fleet_cost_stress"], devices=2, **kw)
    assert sharded.budget.summary() == base.budget.summary()
    hold_result(sharded, base)


def test_cells_refuse_devices():
    spec = TRunSpec(scale=0.1, engines=("simjax",), devices=2)
    with pytest.raises(ValueError, match="do not shard over devices"):
        t_run_scenario("region_failover", spec=spec, device="cpu")
    with pytest.raises(ValueError, match="do not shard over devices"):
        t_evaluate_points(None, t_scenario("region_failover").policy.to_jax(), T.JaxFleet(),
                          [{}], cells=([], None), devices=2, device="cpu")


def test_cuda_shards_beyond_the_visible_devices_raise():
    """No quiet fallback: without ``device="cpu"`` the shards are CUDA
    devices, and asking for more than are visible raises."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=rf"only {n} local CUDA device"):
        T.simulate_chunked(port_trace(EVENTS61), T.JaxPolicy(kind=0),
                           spec=TRunSpec(devices=n + 1))


def _run_cli(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:            # argparse's usage errors
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_scenario_cli_at_two_shards_prints_what_jax_prints(jax_rows, capsys):
    want = jax_rows["cli"]
    rc, out, err = _run_cli(TCLI.main, SCENARIO_ARGV + ["--device", "cpu"], capsys)
    assert rc == want["rc"] == 0 and err == ""
    g, w = without_walls(out), without_walls(want["out"])
    assert same_text(g, w, CLI_RTOL), (g, w)
    assert len(out.splitlines()) == 2 and "fig9_planet" in out.splitlines()[1]


def _same_json(got, want, rtol, path=""):
    """JSON values: the same keys, numbers within ``rtol``, walls and the
    ``devices`` setting aside."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            if k not in ("wall_s", "stage_wall_s", "devices"):
                _same_json(got[k], want[k], rtol, f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_json(g, w, rtol, f"{path}/{i}")
    elif isinstance(want, float):
        assert math.isnan(want) and math.isnan(got) or \
            got == pytest.approx(want, rel=rtol, abs=1e-12), path
    else:
        assert got == want, path


def test_frontier_cli_at_two_shards_writes_its_unsharded_artifacts(tmp_path, capsys):
    argv = ["--scenario", "cold_tail", "--scale", "0.1", "--coarse-frac", "0.5",
            "--spot-check", "0", "--quiet", "--device", "cpu"]
    d0, d2 = tmp_path / "d0", tmp_path / "d2"
    assert _run_cli(TFRONTIER.main, argv + ["--out-dir", str(d0)], capsys)[0] == 0
    assert _run_cli(TFRONTIER.main, argv + ["--out-dir", str(d2), "--devices", "2"],
                    capsys)[0] == 0
    names = sorted(p.name for p in d0.iterdir())
    assert sorted(p.name for p in d2.iterdir()) == names and "frontier.json" in names
    for name in names:
        g, w = (d2 / name).read_text(), (d0 / name).read_text()
        if name.endswith(".csv"):
            assert same_text(g, w, UNSHARDED_RTOL), (name, g, w)
        else:
            _same_json(json.loads(g), json.loads(w), UNSHARDED_RTOL, name)
    meta = json.loads((d2 / "frontier.json").read_text())
    assert json.dumps(meta).count('"devices": 2') >= 1
