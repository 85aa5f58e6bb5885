"""tools/rwkv6_drift.py on the CPU at rwkv6-3b's smoke config: every case
runs and is written, the kernel path (the plain version, on the CPU) does not
drift from attn_impl="ref", a 1e-6 perturbation moves float32 logits by a
little, and the model's functions are restored afterwards."""

import importlib.util
import json
from pathlib import Path

import pytest

from repro_torch.kernels.rwkv6_scan import rwkv6_scan_ref
from repro_torch.models import rwkv6

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location("rwkv6_drift",
                                                  ROOT / "tools" / "rwkv6_drift.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("drift") / "drift.jsonl"
    norm = rwkv6._group_norm
    assert _tool().main(["--device", "cpu", "--smoke", "--out", str(out)]) == 0
    assert rwkv6.rwkv6_scan_ref is rwkv6_scan_ref and rwkv6._group_norm is norm
    return [json.loads(line) for line in out.read_text().splitlines()]


def test_every_case_is_written(rows):
    cases = [(r["dtype"], r["case"], r["seed"]) for r in rows]
    for dtype in ("bfloat16", "float32"):
        assert [c for d, c, _ in cases if d == dtype][:7] == ["ref", "kernel"] + ["scan_noise"] * 5
        assert (dtype, "gn_eps.kernel", None) in cases
        assert (dtype, "gn_eps.scan_noise", 0) in cases
    # a 1e-6 change of a bfloat16 embedding rounds away: float32 only
    assert [s for d, c, s in cases if (d, c) == ("float32", "embed_noise")] == [0, 1, 2]
    assert ("bfloat16", "embed_noise", 0) not in cases
    for r in rows:
        if r["case"] == "ref":
            assert len(r["y_std"]) == 2                 # one group norm per layer
        else:
            assert len(r["hidden"]) == 2 and list(r["logits"]) == ["2"]


def test_kernel_path_does_not_drift_on_the_cpu(rows):
    for r in rows:
        if r["case"] in ("kernel", "gn_eps.kernel"):
            assert all(h["all"] == 0.0 for h in r["hidden"])
            assert r["logits"]["2"]["all"] == 0.0


def test_float32_perturbations_move_the_logits_a_little(rows):
    for r in rows:
        if r["dtype"] == "float32" and "noise" in r["case"]:
            d = r["logits"]["2"]
            assert 0.0 < d["all"] < 1e-3
            assert d["all"] == max(d["first_chunk"], d["rest"])
