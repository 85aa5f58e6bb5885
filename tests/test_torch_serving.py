"""The port's serving stack: control plane, replicas and CLI, held to the JAX
package where both can run the same thing."""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import control_plane as jcp
from repro.core import policies as jpolicies
from repro.serving import engine as jengine
from repro_torch.configs import get_smoke_config
from repro_torch.core import control_plane as tcp
from repro_torch.core import policies as tpolicies
from repro_torch.models import convert
from repro_torch.serving import engine as tengine

ROOT = Path(__file__).resolve().parents[1]
BF16 = dict(param_dtype="bfloat16", remat="none")
F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
CFG = get_smoke_config("gemma3-4b").replace(**BF16, attn_impl="kernel")
MOE = "deepseek-moe-16b"
MOE_CFG = get_smoke_config(MOE).replace(**BF16, attn_impl="kernel")
RWKV = "rwkv6-3b"
RWKV_CFG = get_smoke_config(RWKV).replace(**BF16, attn_impl="kernel")
HYMBA = "hymba-1.5b"
WHISPER = "whisper-tiny"

POLICIES = {
    "sync": dict(keepalive_s=3.0, container_concurrency=2),
    "async": dict(window_s=4.0, target=0.5, container_concurrency=1, tick_s=0.5),
    "hybrid": dict(min_s=2.0, max_s=20.0, container_concurrency=1),
}


def _drive_sim(cp_mod, policies_mod, engine_mod, policy):
    """Scripted bursts on a virtual clock -> everything the run exposes."""
    backend = cp_mod.SimWorkerBackend(cold_start_s=0.8, default_service_s=0.6,
                                      service_time={1: 1.3})
    cp = cp_mod.ControlPlane(
        backend, lambda f: policies_mod.make_policy(policy, **POLICIES[policy]),
        num_functions=2, tick_s=0.25)
    rng = np.random.default_rng(0)
    arrivals = np.sort(np.concatenate([rng.uniform(0, 2, 6), rng.uniform(9, 10, 5),
                                       rng.uniform(25, 26, 3)]))
    fns = rng.integers(0, 2, len(arrivals))
    snaps, i, t = [], 0, 0.0
    for _ in range(240):
        t = round(t + 0.25, 6)
        while i < len(arrivals) and arrivals[i] <= t:
            cp.submit(engine_mod.ServeRequest(rid=i, fn=int(fns[i]), prompt=[],
                                              arrival_t=t), t)
            i += 1
        cp.tick(t)
        snaps.append(cp.snapshot())
    return dict(rids=[r.rid for r in cp.completed], done_t=[r.done_t for r in cp.completed],
                cold=[r.cold for r in cp.completed], creations=backend.creations,
                teardowns=backend.teardowns, snaps=snaps)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_sim_control_plane_identical_to_jax(policy):
    ours = _drive_sim(tcp, tpolicies, tengine, policy)
    ref = _drive_sim(jcp, jpolicies, jengine, policy)
    assert len(ours["rids"]) == 14
    assert ours == ref


def _run_to_done(rep, reqs, max_steps=60):
    for r in reqs:
        assert rep.add(r, 0.0)
    done = []
    for t in range(max_steps):
        done += rep.step(float(t))
        if len(done) == len(reqs):
            break
    return {r.rid: r.output for r in done}


def test_replica_greedy_outputs_equal_jax():
    """Same weights (carried across), same prompts: same greedy tokens."""
    _greedy_outputs_equal_jax("gemma3-4b")


def test_moe_replica_greedy_outputs_equal_jax():
    _greedy_outputs_equal_jax(MOE)


def test_rwkv6_replica_greedy_outputs_equal_jax():
    _greedy_outputs_equal_jax(RWKV)


def test_hymba_replica_greedy_outputs_equal_jax():
    _greedy_outputs_equal_jax(HYMBA)


def test_whisper_replica_greedy_outputs_equal_jax():
    """Served against the all-zero cross cache, as the JAX replica serves it."""
    _greedy_outputs_equal_jax(WHISPER)


def _greedy_outputs_equal_jax(arch):
    jcfg = jax_smoke(arch).replace(**F32)
    cfg = get_smoke_config(arch).replace(**F32, attn_impl="kernel")
    jrep = jengine.ModelReplica(jcfg, max_slots=2, max_seq=32, seed=7)
    rep = tengine.ModelReplica(cfg, max_slots=2, max_seq=32, seed=7, device="cpu")
    rep.params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jrep.params))

    def reqs(mod):
        return [mod.ServeRequest(rid=0, fn=0, prompt=[3, 1, 4], max_new_tokens=8),
                mod.ServeRequest(rid=1, fn=0, prompt=[15, 9], max_new_tokens=10)]
    ours = _run_to_done(rep, reqs(tengine))
    ref = _run_to_done(jrep, reqs(jengine))
    assert [len(ours[0]), len(ours[1])] == [8, 10]
    assert ours == ref


def test_replica_memory_bytes_equal_jax():
    jrep = jengine.ModelReplica(jax_smoke("gemma3-4b").replace(**BF16),
                                max_slots=2, max_seq=48)
    rep = tengine.ModelReplica(CFG, max_slots=2, max_seq=48, device="cpu")
    assert rep.memory_bytes() == jrep.memory_bytes() > 0


def test_moe_replica_memory_bytes_equal_jax():
    jrep = jengine.ModelReplica(jax_smoke(MOE).replace(**BF16), max_slots=2, max_seq=48)
    rep = tengine.ModelReplica(MOE_CFG, max_slots=2, max_seq=48, device="cpu")
    assert rep.memory_bytes() == jrep.memory_bytes() > 0


def test_rwkv6_replica_memory_bytes_equal_jax():
    jrep = jengine.ModelReplica(jax_smoke(RWKV).replace(**BF16), max_slots=2, max_seq=48)
    rep = tengine.ModelReplica(RWKV_CFG, max_slots=2, max_seq=48, device="cpu")
    assert rep.memory_bytes() == jrep.memory_bytes() > 0


@pytest.mark.parametrize("arch", [HYMBA, WHISPER])
def test_hybrid_and_encdec_replica_memory_bytes_equal_jax(arch):
    jrep = jengine.ModelReplica(jax_smoke(arch).replace(**BF16), max_slots=2, max_seq=48)
    rep = tengine.ModelReplica(get_smoke_config(arch).replace(**BF16, attn_impl="kernel"),
                               max_slots=2, max_seq=48, device="cpu")
    assert rep.memory_bytes() == jrep.memory_bytes() > 0


def test_rwkv6_reused_slot_starts_from_a_fresh_state():
    """A request placed in a slot another request used: the JAX replica leaves
    the old recurrent state there (ROADMAP Queue 3, pinned here); the port's
    replica zeroes it, so the request's logits are those it gets on a fresh
    replica."""
    jcfg = jax_smoke(RWKV).replace(**F32)
    cfg = get_smoke_config(RWKV).replace(**F32, attn_impl="kernel")

    def reqs(mod):
        return [mod.ServeRequest(rid=0, fn=0, prompt=[3, 1, 4], max_new_tokens=2),
                mod.ServeRequest(rid=1, fn=0, prompt=[15, 9, 2, 6], max_new_tokens=9),
                mod.ServeRequest(rid=2, fn=0, prompt=[5, 3, 5], max_new_tokens=4)]

    # JAX: slot 0 still holds request 0's state when request 2 is added there
    jrep = jengine.ModelReplica(jcfg, max_slots=2, max_seq=32, seed=7)
    j0, j1, j2 = reqs(jengine)
    assert jrep.add(j0, 0.0) and jrep.add(j1, 0.0)
    while not j0.done:
        jrep.step(0.0)
    assert jrep.add(j2, 1.0) and jrep.slots[0] is j2
    s_slot0 = np.asarray(jrep.cache[0][0]["S"])[:, 0]
    assert np.abs(s_slot0).max() > 1e-3

    def logged(rep, slot, into):
        decode = rep._decode

        def run(tokens, pos):
            logits = decode(tokens, pos)
            into.append(logits[slot, 0].clone())
            return logits
        rep._decode = run

    rep = tengine.ModelReplica(cfg, max_slots=2, max_seq=32, seed=7, device="cpu")
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jrep.params))
    rep.params = params
    r0, r1, r2 = reqs(tengine)
    assert rep.add(r0, 0.0) and rep.add(r1, 0.0)
    while not r0.done:
        rep.step(0.0)
    reused = []
    assert rep.add(r2, 1.0) and rep.slots[0] is r2
    assert all(float(layer["S"][0].abs().max()) == 0.0 for layer in rep.cache)
    logged(rep, 0, reused)
    while not r2.done:
        rep.step(1.0)

    fresh_rep = tengine.ModelReplica(cfg, max_slots=2, max_seq=32, seed=7, device="cpu")
    fresh_rep.params = params
    fresh, f2 = [], reqs(tengine)[2]
    assert fresh_rep.add(f2, 0.0) and fresh_rep.slots[0] is f2
    logged(fresh_rep, 0, fresh)
    while not f2.done:
        fresh_rep.step(0.0)
    assert len(reused) == len(fresh) == 3 + 4 - 1
    for a, b in zip(reused, fresh):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert r2.output == f2.output


def test_hymba_reused_slot_starts_from_a_fresh_state():
    """A request placed in a slot another request used: the JAX replica leaves
    the old Mamba state (ssm_h, conv) there (ROADMAP Queue 3, pinned here); the
    port's replica zeroes it and leaves the attention caches, so the request's
    logits are those it gets on a fresh replica.  The first request stays short
    of the smoke ring's wrap onto the meta positions' slots (W - M = 8 tokens;
    tests/test_torch_hymba.py pins what a longer one leaves there)."""
    jcfg = jax_smoke(HYMBA).replace(**F32)
    cfg = get_smoke_config(HYMBA).replace(**F32, attn_impl="kernel")

    def reqs(mod):
        return [mod.ServeRequest(rid=0, fn=0, prompt=[3, 1, 4], max_new_tokens=2),
                mod.ServeRequest(rid=1, fn=0, prompt=[15, 9, 2, 6], max_new_tokens=9),
                mod.ServeRequest(rid=2, fn=0, prompt=[5, 3, 5], max_new_tokens=4)]

    jrep = jengine.ModelReplica(jcfg, max_slots=2, max_seq=32, seed=7)
    j0, j1, j2 = reqs(jengine)
    assert jrep.add(j0, 0.0) and jrep.add(j1, 0.0)
    while not j0.done:
        jrep.step(0.0)
    assert jrep.add(j2, 1.0) and jrep.slots[0] is j2
    jlayer = jrep.cache[0][0]
    assert np.abs(np.asarray(jlayer["conv"])[0]).max() > 1e-3
    assert np.abs(np.asarray(jlayer["ssm_h"])[0]).max() > 1e-4

    def logged(rep, into):
        decode = rep._decode

        def run(tokens, pos):
            logits = decode(tokens, pos)
            into.append(logits[0, 0].clone())
            return logits
        rep._decode = run

    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jrep.params))
    rep = tengine.ModelReplica(cfg, max_slots=2, max_seq=32, seed=7, device="cpu")
    rep.params = params
    r0, r1, r2 = reqs(tengine)
    assert rep.add(r0, 0.0) and rep.add(r1, 0.0)
    while not r0.done:
        rep.step(0.0)
    attn_before = [{k: layer[k][0].clone() for k in ("k", "v")} for layer in rep.cache]
    assert any(float(layer["ssm_h"][0].abs().max()) > 0 for layer in rep.cache)
    reused = []
    assert rep.add(r2, 1.0) and rep.slots[0] is r2
    for layer, before in zip(rep.cache, attn_before):
        assert float(layer["ssm_h"][0].abs().max()) == float(layer["conv"][0].abs().max()) == 0
        assert all(torch.equal(layer[k][0], before[k]) for k in ("k", "v"))
    logged(rep, reused)
    while not r2.done:
        rep.step(1.0)

    fresh_rep = tengine.ModelReplica(cfg, max_slots=2, max_seq=32, seed=7, device="cpu")
    fresh_rep.params = params
    fresh, f2 = [], reqs(tengine)[2]
    assert fresh_rep.add(f2, 0.0) and fresh_rep.slots[0] is f2
    logged(fresh_rep, fresh)
    while not f2.done:
        fresh_rep.step(0.0)
    assert len(reused) == len(fresh) == 3 + 4 - 1
    for a, b in zip(reused, fresh):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert r2.output == f2.output


def test_replica_continuous_batching():
    replica = tengine.ModelReplica(CFG, max_slots=2, max_seq=48, device="cpu")
    assert replica.cold_start_s > 0 and replica.decode_steps == 1
    r1 = tengine.ServeRequest(rid=1, fn=0, prompt=[1, 2, 3], max_new_tokens=4)
    r2 = tengine.ServeRequest(rid=2, fn=0, prompt=[4, 5], max_new_tokens=6)
    assert replica.add(r1, 0.0) and replica.add(r2, 0.0)
    assert replica.free_slots == 0
    done = []
    for t in range(40):
        done += replica.step(float(t))
        if len(done) == 2:
            break
    assert {r.rid for r in done} == {1, 2}
    assert len(r1.output) == 4 and len(r2.output) == 6
    assert replica.free_slots == 2


def test_control_plane_with_real_torch_replicas_on_cpu():
    _serve_three_on_cpu(CFG)


def test_control_plane_with_real_moe_replicas_on_cpu():
    _serve_three_on_cpu(MOE_CFG)


def _serve_three_on_cpu(cfg):
    backend = tcp.TorchWorkerBackend(cfg, max_slots=2, max_seq=48, device="cpu")
    cp = tcp.ControlPlane(backend, lambda f: tpolicies.SyncKeepalivePolicy(
        keepalive_s=60.0, container_concurrency=2), num_functions=1)
    t0 = time.monotonic()

    def now():
        return time.monotonic() - t0
    for i in range(3):
        cp.submit(tengine.ServeRequest(rid=i, fn=0, prompt=[1, 2], max_new_tokens=3,
                                       arrival_t=now()), now())
    deadline = time.monotonic() + 60
    while len(cp.completed) < 3 and time.monotonic() < deadline:
        cp.tick(now())
    assert len(cp.completed) == 3
    assert all(len(r.output) == 3 for r in cp.completed)
    assert backend.creations >= 1 and backend.cold_start_times[0] > 0
    # every replica's warm-up step is counted, then at least 4 steps
    # (2 prompt tokens + 3 new tokens, the last prompt step emitting the first)
    assert backend.decode_steps >= backend.creations + 4


def test_serve_cli_on_cpu():
    _serve_cli_on_cpu([])


def test_serve_cli_on_cpu_moe():
    _serve_cli_on_cpu(["--arch", MOE])


def test_serve_cli_on_cpu_rwkv6():
    _serve_cli_on_cpu(["--arch", RWKV])


def test_serve_cli_on_cpu_hymba():
    _serve_cli_on_cpu(["--arch", HYMBA])


def test_serve_cli_on_cpu_whisper():
    _serve_cli_on_cpu(["--arch", WHISPER])


def _serve_cli_on_cpu(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args, "--device", "cpu",
         "--duration", "2", "--rps", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "served 4/4 requests" in proc.stdout
