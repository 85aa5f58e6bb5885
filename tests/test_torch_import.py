"""The port's import rule and device rule.

``repro_torch`` (every module of it), ``chip_smoke.py`` and every script
under ``tools/`` import neither jax nor any module of the JAX package
``repro``; entry points given no device
run on CUDA and raise where there is none.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.control_plane import TorchWorkerBackend
from repro_torch.core.simtorch import JaxPolicy, simulate, simulate_chunked
from repro_torch.core.trace import TraceConfig, synthesize
from repro_torch.device import resolve_device
from repro_torch.serving.engine import ModelReplica

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(PKG.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = _modules()
    assert "repro_torch.kernels.decode_attention.ops" in mods
    assert "repro_torch.kernels.moe_gemm.ops" in mods
    assert "repro_torch.kernels.flash_attention.ops" in mods
    assert "repro_torch.kernels.rwkv6_scan.ops" in mods
    assert "repro_torch.models.rwkv6" in mods
    assert "repro_torch.core.simtorch" in mods
    assert "repro_torch.core.policy_api" in mods
    assert "repro_torch.core.trace" in mods
    assert "repro_torch.fleet.billing" in mods
    for mod in ("scenarios", "scenarios.runner", "scenarios.registry", "scenarios.spec",
                "scenarios.transforms", "scenarios.cluster", "cells", "cells.fluid",
                "cells.traffic", "cells.topology", "cells.triggers", "cells.oracle",
                "cells.family", "launch.flags", "launch.scenarios", "launch.trace",
                "launch.clitext", "opt", "opt.frontier", "opt.space", "opt.search",
                "opt.learned", "opt.evo", "opt.evo.budget", "opt.evo.nsga", "opt.evo.genome",
                "opt.evo.engine", "fleet.sweep", "launch.frontier"):
        assert f"repro_torch.{mod}" in mods, mod
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "tools").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_no_device_means_cuda_or_raise():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-CUDA error cannot be shown here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    cfg = get_smoke_config("gemma3-4b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelReplica(cfg, max_slots=1, max_seq=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchWorkerBackend(cfg, max_slots=1, max_seq=8)
    trace = synthesize(TraceConfig(num_functions=3, duration_s=20, target_total_rps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate(trace, JaxPolicy(kind=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_chunked(trace, JaxPolicy(kind=0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_chunked(trace, JaxPolicy(kind=0), device="cuda")
    from repro_torch.core.runspec import RunSpec
    from repro_torch.scenarios import run_scenario
    for name in ("diurnal", "region_failover"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_scenario(name, spec=RunSpec(scale=0.1, engines=("simjax",)))
    assert resolve_device("cpu") == torch.device("cpu")
