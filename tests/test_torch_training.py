"""The port's training path held to the JAX package on the CPU: the AdamW
schedule, update and clip on JAX's own state, the data pipeline bit for bit,
three training steps, microbatching, the remat-free overfit of one batch,
step-atomic checkpoints and the CLI's resume.

Weights and optimizer states are carried across with
``convert.params_from_jax`` / ``opt_state_from_jax``; inputs come from numpy
seeds in float32 smoke configs.  Tolerances: 1e-4 of a leaf's largest entry
on parameters and moments, rtol 1e-5 on losses, as the JAX package's own
microbatch test, 5e-4, for microbatching.
"""

import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import registry as jregistry
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training.train_step import TrainConfig as JTrainConfig
from repro.training.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as train_cli
from repro_torch.models import convert, registry
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data, tree
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import TrainConfig, make_train_step

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
TOL = 1e-4


def _cfgs(arch, **over):
    over = {**F32, **over}
    return jax_smoke(arch).replace(**over), get_smoke_config(arch).replace(**over)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed=0):
    jcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, jax.jit(functools.partial(jregistry.init_params, jcfg))(
        jax.random.PRNGKey(seed)))


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _assert_trees_close(got, want, tol=TOL):
    pairs = list(zip(tree.with_paths(got), tree.with_paths(want)))
    assert len(pairs) == len(tree.leaves(want)) > 0
    for (path, a), (wpath, b) in pairs:
        assert path == wpath
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * float(np.max(np.abs(b))) + 1e-30,
                                   err_msg=str(path))


def _random_like(jtree, seed, scale=1e-2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                        jtree)


# -- optimizer ----------------------------------------------------------------------------


def test_lr_schedule_matches_jax_over_warmup_and_decay():
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=50, min_lr_frac=0.1)
    steps = [0, 1, 5, 9, 10, 11, 20, 30, 49, 50, 60]
    want = [float(jopt.lr_schedule(jopt.AdamWConfig(*cfg), jnp.asarray(s, jnp.int32)))
            for s in steps]
    got = [opt.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)).item() for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[4] == pytest.approx(1e-3) and got[-1] == pytest.approx(1e-4)


def test_adamw_update_matches_jax_on_its_own_state():
    """Two JAX updates make a mid-run state (step 2, non-zero moments); the
    third update from it, in both packages."""
    arch = "gemma3-4b"
    jcfg, cfg = _cfgs(arch)
    acfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jacfg = jopt.AdamWConfig(*acfg)
    jp = jax.tree.map(jnp.asarray, _jax_params(arch))
    jstate = jopt.adamw_init(jp)
    for i in range(2):
        jp, jstate, _ = jopt.adamw_update(jacfg, jax.tree.map(jnp.asarray, _random_like(jp, i)),
                                          jp, jstate)
    grads = _random_like(jp, 7)
    params = convert.params_from_jax(cfg, _np(jp))
    state = convert.opt_state_from_jax(cfg, _np(jstate))
    assert state["step"].item() == 2 and state["step"].dtype == torch.int32
    want_p, want_s, want_lr = jopt.adamw_update(jacfg, jax.tree.map(jnp.asarray, grads), jp,
                                                jstate)
    got_p, got_s, got_lr = opt.adamw_update(acfg, convert.params_from_jax(cfg, grads),
                                            params, state)
    assert got_p is params                          # in place
    np.testing.assert_allclose(got_lr.item(), float(want_lr), rtol=1e-6)
    assert got_s["step"].item() == int(want_s["step"]) == 3
    _assert_trees_close(got_p, convert.params_from_jax(cfg, _np(want_p)), 1e-6)
    for k in ("m", "v"):
        _assert_trees_close(got_s[k], convert.params_from_jax(cfg, _np(want_s[k])), 1e-6)


def test_adamw_update_in_pieces_equals_one_piece(monkeypatch):
    """UPDATE_CHUNK bounds the temporaries; the arithmetic is elementwise, so
    the pieces change no bit."""
    _, cfg = _cfgs("gemma3-4b")
    jp = _jax_params("gemma3-4b")
    grads = convert.params_from_jax(cfg, _random_like(jp, 3))
    outs = []
    for chunk in (opt.UPDATE_CHUNK, 1000):
        monkeypatch.setattr(opt, "UPDATE_CHUNK", chunk)
        params = convert.params_from_jax(cfg, jp)
        state = opt.adamw_init(params)
        opt.adamw_update(opt.AdamWConfig(warmup_steps=0), grads, params, state)
        outs.append((params, state))
    for a, b in zip(tree.leaves(outs[0]), tree.leaves(outs[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    arch = "gemma3-4b"
    _, cfg = _cfgs(arch)
    g = _random_like(_jax_params(arch), 4, 0.1)
    want, want_norm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    got, got_norm = opt.clip_by_global_norm(convert.params_from_jax(cfg, g), max_norm)
    np.testing.assert_allclose(got_norm.item(), float(want_norm), rtol=1e-5)
    assert (got_norm.item() > max_norm) == (max_norm == 1.0)
    _assert_trees_close(got, convert.params_from_jax(cfg, _np(want)), 1e-6)
    np.testing.assert_allclose(opt.global_norm(got).item(), min(max_norm, got_norm.item()),
                               rtol=1e-5)


# -- data ---------------------------------------------------------------------------------


@pytest.mark.parametrize("seq_len,batch,seed,mean_doc", [(64, 4, 0, 512.0), (37, 3, 5, 9.0)])
def test_batch_at_is_bit_equal_to_jax(seq_len, batch, seed, mean_doc):
    cfg = data.DataConfig(vocab_size=512, seq_len=seq_len, global_batch=batch, seed=seed,
                          mean_doc_len=mean_doc)
    jcfg = jdata.DataConfig(vocab_size=512, seq_len=seq_len, global_batch=batch, seed=seed,
                            mean_doc_len=mean_doc)
    for step in (0, 1, 7, 1000):
        got, want = data.batch_at(cfg, step), jdata.batch_at(jcfg, step)
        assert sorted(got) == sorted(want) == ["loss_mask", "targets", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        tb = data.torch_batch_at(cfg, step, "cpu", {"extra": torch.ones(1)})
        for k in want:
            np.testing.assert_array_equal(tb[k].numpy(), want[k])
        assert tb["extra"].item() == 1.0
    assert (got["loss_mask"] == 0).any() or mean_doc > seq_len


# -- training steps -------------------------------------------------------------------------


def _extras(cfg, b):
    if cfg.family == "vlm":
        return {"patch_embeds": np.zeros((b, cfg.num_patches, cfg.d_model), np.float32)}
    if cfg.family == "encdec":
        return {"enc_embeds": np.zeros((b, cfg.encoder_seq, cfg.d_model), np.float32)}
    return {}


@pytest.mark.parametrize("arch", ["gemma3-4b", "hymba-1.5b", "deepseek-moe-16b"])
def test_three_train_steps_match_jax(arch):
    """Loss curve, grad norms, lr, aux and the parameters and moments after
    three steps of train_step, from one JAX init.  At lr 1e-4: Adam's m / sqrt(v)
    magnifies the two packages' float32 rounding where a gradient component
    changes sign between steps, by an amount in proportion to lr, which at
    lr 1e-3 comes near the 1e-4 bound."""
    jcfg, cfg = _cfgs(arch)
    acfg = opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10)
    dc = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2,
                         mean_doc_len=12)
    jstep = jax.jit(jmake_train_step(jcfg, JTrainConfig(adamw=jopt.AdamWConfig(*acfg))))
    step = make_train_step(cfg, TrainConfig(adamw=acfg))
    jp = jax.tree.map(jnp.asarray, _jax_params(arch))
    jo = jopt.adamw_init(jp)
    params = convert.params_from_jax(cfg, _jax_params(arch))
    state = opt.adamw_init(params)
    for i in range(3):
        b = {**data.batch_at(dc, i), **_extras(cfg, 2)}
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(m) == sorted(jm)
        for k in m:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    _assert_trees_close(params, convert.params_from_jax(cfg, _np(jp)))
    state_want = convert.opt_state_from_jax(cfg, _np(jo))
    assert state["step"].item() == state_want["step"].item() == 3
    for k in ("m", "v"):
        _assert_trees_close(state[k], state_want[k])


def test_microbatch_two_matches_one():
    """n_microbatches=2 accumulates float32 grads over the halves of the batch:
    the update agrees with the whole batch's within the JAX package's 5e-4."""
    _, cfg = _cfgs("gemma3-4b")
    dc = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
    batch = data.torch_batch_at(dc, 3, "cpu")
    outs = []
    for n in (1, 2):
        params = convert.params_from_jax(cfg, _jax_params("gemma3-4b"))
        state = opt.adamw_init(params)
        params, state, m = make_train_step(cfg, TrainConfig(n_microbatches=n))(
            params, state, batch)
        outs.append((params, m))
    err = max((a - b).abs().max().item()
              for a, b in zip(tree.leaves(outs[0][0]), tree.leaves(outs[1][0])))
    assert err < 5e-4, err
    assert abs(outs[0][1]["loss"].item() - outs[1][1]["loss"].item()) < 1e-2
    with pytest.raises(ValueError, match="does not split"):
        make_train_step(cfg, TrainConfig(n_microbatches=3))(*outs[0][:1], state, batch)


def test_microbatch_matches_jax_microbatch():
    jcfg, cfg = _cfgs("gemma3-4b")
    tcfg = TrainConfig(n_microbatches=2)
    dc = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    b = data.batch_at(dc, 2)
    jp = jax.tree.map(jnp.asarray, _jax_params("gemma3-4b"))
    jp, jo, jm = jax.jit(jmake_train_step(jcfg, JTrainConfig(n_microbatches=2)))(
        jp, jopt.adamw_init(jp), {k: jnp.asarray(v) for k, v in b.items()})
    params = convert.params_from_jax(cfg, _jax_params("gemma3-4b"))
    params, state, m = make_train_step(cfg, tcfg)(params, opt.adamw_init(params),
                                                  {k: torch.from_numpy(v) for k, v in b.items()})
    assert sorted(m) == sorted(jm) == ["grad_norm", "loss", "lr"]
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    # the first moments are the accumulated, clipped gradients times 1 - b1;
    # the parameters moved by 3e-6 (warmup), which a near-zero gradient's
    # rounding (|g| ~ eps) can move by a few percent in either package
    state_want = convert.opt_state_from_jax(cfg, _np(jo))
    for k in ("m", "v"):
        _assert_trees_close(state[k], state_want[k])


def test_overfit_single_batch():
    _, cfg = _cfgs("gemma3-4b")
    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=50))
    params = registry.init_params(cfg, device="cpu", seed=0)
    state = opt.adamw_init(params)
    step = make_train_step(cfg, tcfg)
    batch = data.torch_batch_at(data.DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                                global_batch=4), 0, "cpu")
    losses = []
    for _ in range(20):
        params, state, m = step(params, state, batch)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 1.0, losses
    assert not any(t.requires_grad for t in tree.leaves(params))


def test_train_step_under_attn_impl_kernel_raises_before_any_update():
    _, cfg = _cfgs("gemma3-4b", attn_impl="kernel")
    params = registry.init_params(cfg, device="cpu", seed=0)
    before = [t.clone() for t in tree.leaves(params)]
    state = opt.adamw_init(params)
    batch = data.torch_batch_at(data.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                                global_batch=2), 0, "cpu")
    with pytest.raises(RuntimeError, match="forward-only kernel"):
        make_train_step(cfg)(params, state, batch)
    assert state["step"].item() == 0
    for a, b in zip(tree.leaves(params), before):
        assert torch.equal(a, b) and not a.requires_grad


# -- checkpoints --------------------------------------------------------------------------


def _small_state():
    _, cfg = _cfgs("gemma3-4b")
    params = registry.init_params(cfg, device="cpu", seed=0)
    return params, opt.adamw_init(params)


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    params, state = _small_state()
    d = str(tmp_path / "ck")
    path = ckpt.save(d, 10, {"p": params, "o": state}, extra={"note": "x"})
    assert sorted(os.listdir(path))[:2] == ["COMMITTED", "meta.json"]
    assert "p_layers_0_attn_wq.npy" in os.listdir(path) and "o_step.npy" in os.listdir(path)
    like = {"p": tree.map_(torch.zeros_like, params), "o": opt.adamw_init(params)}
    step, restored, extra = ckpt.restore_latest(d, like)
    assert step == 10 and extra == {"note": "x"}
    for a, b in zip(tree.leaves(restored), tree.leaves({"p": params, "o": state})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # an uncommitted checkpoint, and a half-written .tmp, are skipped
    os.makedirs(os.path.join(d, "step_00000020"))
    os.makedirs(os.path.join(d, "step_00000030.tmp"))
    assert ckpt.latest_step(d) == 10
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, 20, like)
    assert ckpt.restore_latest(str(tmp_path / "none"), like) is None


def test_checkpoint_bf16_round_trip_is_bit_exact(tmp_path):
    t = torch.randn(5, 7).to(torch.bfloat16)
    t[0, :3] = torch.tensor([float("inf"), -0.0, float("nan")])
    ckpt.save(str(tmp_path), 1, {"w": t, "n": [torch.arange(3)]})
    (got, _) = ckpt.restore(str(tmp_path), 1, {"w": torch.zeros_like(t),
                                               "n": [torch.zeros(3, dtype=torch.int64)]})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), t.view(torch.int16))
    assert torch.equal(got["n"][0], torch.arange(3))


def test_checkpoint_keep_gc(tmp_path):
    params, _ = _small_state()
    d = str(tmp_path / "ck")
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(d, s, {"p": params}, keep=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert steps == ["step_00000004", "step_00000005"]


def test_restart_resumes_identically(tmp_path):
    """Crash/restart reproduces the uninterrupted run exactly."""
    _, cfg = _cfgs("gemma3-4b")
    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=20))
    d = str(tmp_path / "ck")
    dc = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    step = make_train_step(cfg, tcfg)

    p, o = _small_state()
    losses_a = []
    for i in range(6):
        p, o, m = step(p, o, data.torch_batch_at(dc, i, "cpu"))
        losses_a.append(m["loss"].item())

    p2, o2 = _small_state()
    for i in range(3):
        p2, o2, m = step(p2, o2, data.torch_batch_at(dc, i, "cpu"))
    ckpt.save(d, 3, {"p": p2, "o": o2})
    del p2, o2
    fresh_p, fresh_o = _small_state()
    s, restored, _ = ckpt.restore_latest(d, {"p": fresh_p, "o": fresh_o})
    p3, o3 = restored["p"], restored["o"]
    losses_b = []
    for i in range(s, 6):
        p3, o3, m = step(p3, o3, data.torch_batch_at(dc, i, "cpu"))
        losses_b.append(m["loss"].item())
    assert losses_a[3:] == losses_b
    for a, b in zip(tree.leaves(p), tree.leaves(p3)):
        assert torch.equal(a, b)


# -- the CLI -------------------------------------------------------------------------------


def _log(out: str) -> list[str]:
    """The step lines without their timing."""
    return [ln.split(" (")[0] for ln in out.splitlines() if ln.startswith("step ")]


def test_train_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    """A run of 6 steps checkpointing every 2 whose last checkpoint is lost
    (as if it died after step 4's) is rerun: it resumes from step 4 and logs
    steps 5 and 6 as the uninterrupted run did."""
    d = str(tmp_path / "ck")
    args = ["--arch", "gemma3-4b", "--smoke", "--device", "cpu", "--seq-len", "32",
            "--batch", "2", "--log-every", "1", "--ckpt-every", "2", "--warmup", "2",
            "--steps", "6", "--ckpt-dir", d]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    first = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args], env=env,
                           capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    straight = _log(first.stdout)
    assert len(straight) == 6 and "resumed" not in first.stdout
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004", "step_00000006"]
    shutil.rmtree(os.path.join(d, "step_00000006"))
    train_cli.main(args)
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert _log(out) == straight[4:]
    assert ckpt.latest_step(d) == 6


def test_training_entry_points_need_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-CUDA error cannot be shown here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "gemma3-4b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.torch_batch_at(data.DataConfig(vocab_size=8, seq_len=4, global_batch=1), 0)


def test_training_modules_are_under_the_import_rule():
    """tests/test_torch_import.py walks every module of the package; the
    training modules are among them."""
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import test_torch_import
    finally:
        sys.path.pop(0)
    mods = test_torch_import._modules()
    for m in ("repro_torch.training", "repro_torch.training.optimizer",
              "repro_torch.training.data", "repro_torch.training.checkpoint",
              "repro_torch.training.train_step", "repro_torch.training.tree",
              "repro_torch.launch.train"):
        assert m in mods
