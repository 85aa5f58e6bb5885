"""The families under a multi-device mesh on the card, at smoke size:
``chip_smoke.py``'s ``mesh.hold`` and ``mesh.rank`` holds, small.

* Two ranks on cuda:0 (a threaded process group: NCCL takes one rank a
  card), gemma3-4b's smoke config in float32 on a (1, 2) mesh: forward,
  prefill and two decode steps (fed the forward's greedy token) held to the
  unsharded run within 1e-5 of the largest logit.
* One rank of a decode cell on a (4, 2) mesh run on the card at its local
  shapes under a fake group, beside the same rank counted on the meta
  device: matmul FLOPs equal, collectives equal, the peak within
  ``chip_smoke.DRYRUN_PEAK_RTOL``.
* ``mesh.uneven``'s cases one by one: every family on (1, 3) and (4, 2),
  gemma3-4b on (2, 2, 2), threaded ranks on cuda:0, each held to its
  unsharded run within ``chip_smoke.MESH_UNEVEN_TOL`` (the card's torch
  refuses some of what the CPU tests' release takes).
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

pytestmark = pytest.mark.cuda
if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU", allow_module_level=True)

import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import cells, dryrun, op_analysis  # noqa: E402
from repro_torch.models import registry  # noqa: E402

F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def test_two_ranks_on_one_card_hold_the_unsharded_run():
    cfg = get_smoke_config("gemma3-4b").replace(**F32)
    mesh = sh.Mesh(("data", "model"), (1, 2))
    b, s, steps = 2, 24, 2
    params = registry.init_params(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device="cuda", dtype=torch.int32)}

    def calls(p, cache, bt, feed):
        out = [registry.forward(cfg, p, bt)[0]]
        lg, cache = registry.prefill(cfg, p, cache, bt)
        out.append(lg)
        for i in range(steps):
            pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            lg, cache = registry.decode_step(cfg, p, cache, feed[:, i:i + 1], pos)
            out.append(lg)
        return out

    with torch.no_grad():
        fwd = registry.forward(cfg, params, batch)[0]
        feed = fwd[:, -1:].argmax(-1).repeat(1, steps).to(torch.int32)
        ref = calls(params, registry.init_cache(cfg, b, s + steps, device="cuda"), batch, feed)
    with sh.use_mesh(mesh):
        pspecs, cspecs = registry.param_specs(cfg), registry.cache_specs(cfg)

    def rank(r):
        dm = sh.dtensor_mesh(mesh, "cuda")
        dp = sh.distribute_tree(params, pspecs, dm)
        dc = sh.distribute_tree(registry.init_cache(cfg, b, s + steps, device="cuda"),
                                cspecs, dm)
        db = sh.distribute_tree(batch, registry.batch_specs(cfg), dm)
        with torch.no_grad(), sh.use_mesh(mesh):
            return [t.full_tensor() for t in calls(dp, dc, db, feed)]

    with sh.use_mesh(mesh):
        got = chip_smoke.threaded_ranks(mesh.size, rank)
    for outs in got:
        for a, w in zip(outs, ref):
            assert _rel(a, w) <= 1e-5


def test_one_rank_on_the_card_matches_its_count():
    from torch.distributed.tensor import DTensor
    cfg = get_smoke_config("gemma3-4b")
    mesh = sh.Mesh(("data", "model"), (4, 2))
    SHAPES["cuda_decode"] = ShapeConfig("cuda_decode", 1024, 8, "decode")
    try:
        _, _, meta = dryrun.count_rank(cfg, "cuda_decode", mesh)
        with sh.fake_group(mesh.size):
            dm = sh.dtensor_mesh(mesh, "cuda")
            cell, args, _ = cells.build_cell(cfg, "cuda_decode", mesh, dmesh=dm)
            args = tuple(registry_tree(a, lambda x: DTensor.from_local(
                torch.zeros(x.to_local().shape, dtype=x.dtype, device="cuda"), dm,
                x.placements, run_check=False, shape=x.shape, stride=x.stride()))
                for a in args)
            with torch.no_grad():
                card = op_analysis.analyze(cell, *args)
    finally:
        SHAPES.pop("cuda_decode", None)
    assert card["matmul_flops"] == meta["matmul_flops"]
    assert card["collectives"] == meta["collectives"]
    assert abs(card["peak_bytes"] - meta["peak_bytes"]) <= \
        chip_smoke.DRYRUN_PEAK_RTOL * card["peak_bytes"]


def registry_tree(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: registry_tree(v, fn) for k, v in tree.items()}
    return type(tree)(registry_tree(v, fn) for v in tree)


UNEVEN = [(arch, sizes, names) for (sizes, names), archs in chip_smoke.MESH_UNEVEN
          for arch in archs]


@pytest.mark.parametrize("arch,sizes,names", UNEVEN,
                         ids=[f"{a}-{'x'.join(map(str, s))}" for a, s, _ in UNEVEN])
def test_a_family_on_a_mesh_holds_its_unsharded_run(arch, sizes, names):
    got = chip_smoke.mesh_uneven_case(chip_smoke.mesh_modules(), registry,
                                      get_smoke_config(arch).replace(**F32), sizes, names)
    assert got["err"] <= chip_smoke.MESH_UNEVEN_TOL, got
