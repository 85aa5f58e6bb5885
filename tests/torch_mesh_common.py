"""The port's models on a multi-device mesh with real collectives, on the CPU
(not a test module).

``run_mesh(job)`` starts ``prod(mesh sizes)`` processes, one a rank, joined
in a gloo process group through a file store: collectives that move data,
so that the values the sharded models compute can be held.  Every rank
builds the same smoke model from the same parameters (a file the caller
wrote, or the port's seeded init), places the parameter, cache and input
trees on the ``DeviceMesh`` by their logical spec trees
(``sharding.distribute_tree``), runs ``forward``, ``prefill`` and greedy
``decode_step``s under ``use_mesh`` and gathers each output whole; rank 0
also runs the same calls on the plain tensors and writes both.  A job is a
dict:

* ``archs``: arch names; ``mesh``: ``[sizes, names]``;
* ``batch``, ``seq``, ``decode_steps``, ``seed``, ``overrides`` (a dict of
  config fields for every arch);
* ``params``: ``{arch: path}`` of ``torch.save``d parameter trees (the JAX
  package's, carried across) or absent for the port's init;
* ``loss``: archs whose ``loss_fn`` and gradients are also run (float32).

    python tests/torch_mesh_common.py RANK WORLD JOB.json   # one rank
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")


def batch_arrays(cfg, batch: int, seq: int, seed: int) -> dict:
    """The inputs of a forward / prefill, as numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    out["targets"] = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out["loss_mask"] = (rng.random((batch, seq)) > 0.2).astype(np.float32)
    return out


def _calls(cfg, params, cache, batch, steps: int, registry):
    """forward, prefill and ``steps`` greedy decode steps -> dict of tensors
    (the tokens fed are the unsharded run's, passed in ``batch["feed"]``)."""
    import torch
    fwd, _ = registry.forward(cfg, params, batch)
    pre, cache = registry.prefill(cfg, params, cache, batch)
    out = {"forward": fwd, "prefill": pre}
    s = batch["tokens"].shape[1] + (cfg.num_patches if cfg.family == "vlm" else 0)
    for i in range(steps):
        tok = batch["feed"][:, i:i + 1]
        pos = torch.full((tok.shape[0],), s + i, dtype=torch.int32)
        lg, cache = registry.decode_step(cfg, params, cache, tok, pos)
        out[f"decode{i}"] = lg
    return out


def _rank_main(rank: int, world: int, job_path: str) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import registry

    job = json.loads(Path(job_path).read_text())
    work = Path(job["work"])
    dist.init_process_group("gloo", init_method=f"file://{work / 'rdzv'}",
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    sizes, names = job["mesh"]
    mesh = sh.Mesh(tuple(names), tuple(sizes))
    dm = sh.dtensor_mesh(mesh, "cpu")
    results = {}
    for arch in job["archs"]:
        t0 = time.perf_counter()
        cfg = get_smoke_config(arch).replace(**{**F32, **job.get("overrides", {})})
        path = job.get("params", {}).get(arch)
        params = torch.load(path) if path else registry.init_params(
            cfg, device="cpu", seed=job.get("seed", 0))
        arrays = batch_arrays(cfg, job["batch"], job["seq"], job.get("seed", 0))
        batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
        steps = job.get("decode_steps", 2)
        total = job["seq"] + (cfg.num_patches if cfg.family == "vlm" else 0) + steps
        # the unsharded run, on every rank (its tokens feed the decode steps)
        t1 = time.perf_counter()
        ref_batch = dict(batch)
        fwd, _ = registry.forward(cfg, params, ref_batch)
        feed = [fwd[:, -1:].argmax(-1).to(torch.int32)]
        ref = {"forward": fwd}
        cache = registry.init_cache(cfg, job["batch"], total, device="cpu")
        ref["prefill"], cache = registry.prefill(cfg, params, cache, ref_batch)
        s = job["seq"] + (cfg.num_patches if cfg.family == "vlm" else 0)
        for i in range(steps):
            pos = torch.full((job["batch"],), s + i, dtype=torch.int32)
            lg, cache = registry.decode_step(cfg, params, cache, feed[-1], pos)
            ref[f"decode{i}"] = lg
            feed.append(lg[:, -1:].argmax(-1).to(torch.int32))
        batch["feed"] = torch.cat(feed[:steps], dim=1)
        t2 = time.perf_counter()
        # the sharded run
        with sh.use_mesh(mesh):
            pspecs = registry.param_specs(cfg)
            cspecs = registry.cache_specs(cfg)
            bspecs = registry.batch_specs(cfg, train=True)
        bspecs["feed"] = ("batch", None)
        dparams = sh.distribute_tree(params, pspecs, dm)
        dbatch = sh.distribute_tree(batch, bspecs, dm)
        dcache = sh.distribute_tree(registry.init_cache(cfg, job["batch"], total,
                                                        device="cpu"), cspecs, dm)
        with sh.use_mesh(mesh):
            got = _calls(cfg, dparams, dcache, dbatch, steps, registry)
        got = {k: sh.gather_tree(v) for k, v in got.items()}
        t3 = time.perf_counter()
        res = {"ref": {k: v.detach().numpy() for k, v in ref.items()},
               "mesh": {k: v.detach().numpy() for k, v in got.items()}}
        if arch in job.get("loss", ()):
            res.update(_loss(cfg, params, dparams, batch, dbatch, mesh, registry, sh))
        res["seconds"] = {"setup": t1 - t0, "plain": t2 - t1, "mesh": t3 - t2,
                          "loss": time.perf_counter() - t3}
        results[arch] = res
    if rank == 0:
        torch.save(results, work / "results.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _loss(cfg, params, dparams, batch, dbatch, mesh, registry, sh) -> dict:
    """The loss and its gradients, unsharded and on the mesh (gradients
    gathered whole) -> numpy trees."""
    import torch

    def grads(p, b):
        leaves = registry.leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = registry.loss_fn(cfg, p, b)
        g = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        return loss, g

    loss, g = grads(params, batch)
    with sh.use_mesh(mesh):
        dloss, dg = grads(dparams, dbatch)
    return {"loss_ref": loss.detach().numpy(),
            "loss_mesh": sh.gather_tree(dloss).detach().numpy(),
            "grads_ref": [t.numpy() for t in g],
            "grads_mesh": [sh.gather_tree(t).detach().numpy() for t in dg]}


def run_mesh(job: dict, timeout: float = 300.0) -> dict:
    """Run ``job`` over ``prod(sizes)`` gloo ranks -> rank 0's results:
    ``{arch: {"ref": {call: array}, "mesh": {call: array}, ...}}``."""
    import torch
    world = math.prod(job["mesh"][0])
    with tempfile.TemporaryDirectory() as work:
        job = dict(job, work=work)
        path = Path(work) / "job.json"
        path.write_text(json.dumps(job))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        env.pop("JAX_PLATFORMS", None)
        procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(path)],
                                  env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(world)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    errs.append(err[-3000:])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if errs:
            # the rank that failed first, not one its exit cut off
            first = next((e for e in errs if "Connection closed" not in e), errs[0])
            raise RuntimeError("a rank failed:\n" + first)
        return torch.load(Path(work) / "results.pt", weights_only=False)


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
