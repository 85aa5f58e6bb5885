"""``repro_torch.launch.frontier`` against ``repro.launch.frontier``.

Each CLI runs in this process, the port with ``--device cpu``, on the same
arguments: the same exit code, the same artifacts (``frontier_<scenario>.csv``
and ``frontier_robust.csv`` as text equal but for their numbers, each within
rtol 1e-3 or one unit of its last printed digit; ``frontier.json`` and
``telemetry.json`` with the same keys and values, numbers within rtol 1e-3,
walls aside), the same ``--list`` output, and the same exit 2 and message on
a bad flag.  Without ``--device`` on a machine with no CUDA the port's CLI
raises and its process exits non-zero.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.launch.frontier as JCLI

import repro_torch.launch.frontier as TCLI

from torch_scenario_common import CLI_RTOL, same_text

ROOT = Path(__file__).resolve().parents[1]
WALLS = {"wall_s", "stage_wall_s"}


def _run(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:            # argparse's usage errors
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def _same(got, want, path="") -> None:
    """JSON values: the same keys and types, numbers within CLI_RTOL, walls
    aside."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got, want)
        for k in want:
            if k not in WALLS:
                _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}/{i}")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), path
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            assert got == pytest.approx(want, rel=CLI_RTOL, abs=1e-12), path
    else:
        assert got == want, path


CASES = {
    "grid": ["--scenario", "cold_tail", "--scale", "0.1", "--coarse-frac", "0.5",
             "--spot-check", "0"],
    # the verify recipe's frontier smoke
    "learned": ["--scenario", "fleet_cost_stress", "--scale", "0.1", "--coarse-frac", "0.5",
                "--spot-check", "0", "--learned", "--learn-steps", "8"],
    "evo": ["--scenario", "fleet_cost_stress", "--scale", "0.1", "--coarse-frac", "1.0",
            "--algo", "evo", "--budget", "16", "--seed", "0", "--spot-check", "1",
            "--telemetry"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_artifacts_equal_jax(case, tmp_path, capsys):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    argv = CASES[case] + ["--quiet"]
    want = _run(JCLI.main, argv + ["--out-dir", str(jdir)], capsys)
    got = _run(TCLI.main, argv + ["--out-dir", str(tdir), "--device", "cpu"], capsys)
    assert got == want and got[0] == 0
    names = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == names
    assert "frontier.json" in names and "frontier_robust.csv" in names
    for name in names:
        g, w = (tdir / name).read_text(), (jdir / name).read_text()
        if name.endswith(".csv"):
            assert same_text(g, w, CLI_RTOL), (name, g, w)
        else:
            _same(json.loads(g), json.loads(w), name)
    if case == "learned":
        rec = json.loads((tdir / "frontier.json").read_text())["learned"][0]
        assert rec["train"]["steps"] == 8 and "oracle" in rec


@pytest.mark.parametrize("argv", [
    ["--list"],
    ["--algo", "bogus"],
    ["--algo", "evo", "--budget", "-4"],
    ["--scenario", "nope"],
    ["--billing", "nope"],
    ["--tier", "nope"],
    ["--devices", "-1"],
    ["--cluster", "-0.5"],
], ids=lambda a: " ".join(a))
def test_list_and_flag_errors_equal_jax(argv, capsys):
    want = _run(JCLI.main, argv, capsys)
    got = _run(TCLI.main, argv, capsys)
    assert got == want
    assert got[0] == (0 if argv == ["--list"] else 2)


def test_without_a_device_the_cli_exits_non_zero(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-CUDA error cannot be shown here")
    argv = CASES["grid"] + ["--quiet", "--out-dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCLI.main(argv)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.frontier", *argv],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "out").exists()
