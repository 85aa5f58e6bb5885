"""Shared helpers of the optimizer's CPU parity tests (not a test module)."""

import dataclasses
import math

import numpy as np
import pytest

ROW_RTOL, SLOWDOWN_RTOL = 1e-4, 1e-3
WALLS = {"stage_wall_s", "wall_s"}


def hold_row(got: dict, want: dict, rtol: float = ROW_RTOL,
             slowdown_rtol: float = SLOWDOWN_RTOL) -> None:
    """The same keys; every number within the row tolerances (the slowdown
    within its own), every other field equal; walls skipped."""
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for k, v in want.items():
        if k in WALLS:
            continue
        if isinstance(v, (float, np.floating)) and not isinstance(v, bool):
            if math.isnan(v):
                assert math.isnan(got[k]), k
                continue
            tol = slowdown_rtol if k == "slowdown_geomean_p99" else rtol
            assert float(got[k]) == pytest.approx(float(v), rel=tol, abs=1e-12), k
        else:
            assert got[k] == v, k


def hold_rows(got: list, want: list, **kw) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        hold_row(g, w, **kw)


def hold_result(got, want) -> None:
    """Two ``FrontierResult``s: the same candidates, rows at the row
    tolerances, the same fronts and robust ids, the hypervolume at 1e-4."""
    from repro_torch.opt.search import _front_hypervolume
    assert got.points == want.points
    assert (got.scale, got.coarse_scale, got.algo) == (want.scale, want.coarse_scale, want.algo)
    for stage in ("coarse", "refined"):
        a, b = getattr(got, stage), getattr(want, stage)
        assert a.keys() == b.keys()
        for name in b:
            hold_rows(a[name], b[name])
    assert {n: [r["point_id"] for r in f] for n, f in got.fronts.items()} == \
        {n: [r["point_id"] for r in f] for n, f in want.fronts.items()}
    assert got.robust_ids == want.robust_ids
    for name in want.refined:
        assert _front_hypervolume(got.refined[name]) == pytest.approx(
            _front_hypervolume(want.refined[name]), rel=1e-4)


def fields(x):
    """A dataclass tree as (class name, fields) tuples, for comparing the two
    packages' objects field for field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: fields(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return tuple(fields(v) for v in x)
    if isinstance(x, dict):
        return {k: fields(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.tolist())
    return x
