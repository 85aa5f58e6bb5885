"""The training path on the card: the kernel wrappers refuse to be
differentiated on CUDA tensors and launch under ``torch.no_grad()``, a
training step under ``attn_impl="kernel"`` raises, training steps on the card
agree with the same steps on the CPU, checkpoints of card tensors round-trip,
and the CLI runs on the card by default.

Imports no jax, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_training_cuda.py

The card tests carry the ``cuda`` marker and skip where there is no card.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.decode_attention import ops as k1
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention import ops as k2
from repro_torch.kernels.moe_gemm import moe_expert_ffn_ref
from repro_torch.kernels.moe_gemm import ops as k3
from repro_torch.kernels.rwkv6_scan import ops as k4
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import registry
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data, tree
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import TrainConfig, make_train_step

F32 = dict(param_dtype="float32", compute_dtype="float32")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _calls():
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    q, k, v = rand(1, 128, 4, 64), rand(1, 128, 2, 64), rand(1, 128, 2, 64)
    q1 = rand(1, 1, 4, 64)
    pos = torch.tensor([100], dtype=torch.int32, device="cuda")
    # fan-in scaled weights, as the models' (K3's bf16 designs round h to bf16)
    x, wg, wu, wo = rand(4, 16, 64), rand(4, 64, 128) / 8, rand(4, 64, 128) / 8, \
        rand(4, 128, 64) / 11.3
    r, kr, vr = rand(1, 64, 2, 64), rand(1, 64, 2, 64), rand(1, 64, 2, 64)
    lw, u = -rand(1, 64, 2, 64).abs().float(), rand(2, 64).float()
    return {
        "K1": (k1, lambda t: k1.decode_attention(*t, pos),
               lambda t: decode_attention_ref(*t, pos), [q1, k, v], 2e-2),
        "K2": (k2, lambda t: k2.flash_attention(*t), lambda t: flash_attention_ref(*t),
               [q, k, v], 2e-2),
        "K2._launch": (k2, lambda t: k2._launch("mma", *t), lambda t: flash_attention_ref(*t),
                       [q, k, v], 2e-2),
        "K3": (k3, lambda t: k3.moe_expert_ffn(*t), lambda t: moe_expert_ffn_ref(*t),
               [x, wg, wu, wo], 8e-2),
        "K3._launch": (k3, lambda t: k3._launch("wgmma", *t), lambda t: moe_expert_ffn_ref(*t),
                       [x, wg, wu, wo], 8e-2),
        "K4": (k4, lambda t: k4.rwkv6_scan(*t)[0], lambda t: rwkv6_scan_ref(*t)[0],
               [r, kr, vr, lw, u], 2e-3),
        "K4._launch": (k4, lambda t: k4._launch(*t, None, k4.SEGMENT)[0],
                       lambda t: rwkv6_scan_ref(*t)[0], [r, kr, vr, lw, u], 2e-3),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["K1", "K2", "K2._launch", "K3", "K3._launch", "K4",
                                  "K4._launch"])
def test_kernel_refuses_grad_and_launches_under_no_grad(name):
    _need_cuda()
    ops, call, ref, inputs, tol = _calls()[name]
    for j in range(len(inputs)):
        ts = [t.clone().requires_grad_(n == j) for n, t in enumerate(inputs)]
        n0 = ops.launches
        with pytest.raises(RuntimeError, match="forward-only kernel.*attn_impl=\"ref\""):
            call(ts)
        assert ops.launches == n0
    with torch.no_grad():
        n0 = ops.launches
        out = call([t.clone().requires_grad_(True) for t in inputs])
        torch.cuda.synchronize()
        assert ops.launches == n0 + 1
    torch.testing.assert_close(out.float(), ref(inputs).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-moe-16b", "rwkv6-3b", "hymba-1.5b"])
def test_train_step_under_attn_impl_kernel_raises_on_card(arch):
    _need_cuda()
    cfg = get_smoke_config(arch).replace(attn_impl="kernel", **F32)
    params = registry.init_params(cfg, device="cuda", seed=0)
    state = opt.adamw_init(params)
    before = [t.clone() for t in tree.leaves(params)]
    batch = data.torch_batch_at(data.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                                global_batch=2), 0, "cuda")
    with pytest.raises(RuntimeError, match="forward-only kernel"):
        make_train_step(cfg)(params, state, batch)
    assert state["step"].item() == 0
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(params), before))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-4b", "hymba-1.5b"])
def test_train_steps_on_card_match_cpu(arch):
    """Three steps from one CPU-made init: losses within 1e-4, parameters
    within 1e-4 of each leaf's largest entry (at lr 1e-4, as chip_smoke.py's
    train.family: Adam magnifies float32 rounding in proportion to lr)."""
    _need_cuda()
    cfg = get_smoke_config(arch).replace(remat="full", **F32)
    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10))
    dc = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2,
                         mean_doc_len=12)
    init = registry.init_params(cfg, device="cpu", seed=0)
    out = {}
    for dev in ("cuda", "cpu"):
        params = tree.map_(lambda t, d=dev: t.clone().to(d), init)
        state = opt.adamw_init(params)
        step = make_train_step(cfg, tcfg)
        losses = []
        for i in range(3):
            params, state, m = step(params, state, data.torch_batch_at(dc, i, dev))
            losses.append(m["loss"].item())
        out[dev] = (losses, params)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for a, b in zip(tree.leaves(out["cuda"][1]), tree.leaves(out["cpu"][1])):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * b.abs().max().item() + 1e-30)


@pytest.mark.cuda
def test_checkpoint_round_trips_card_tensors(tmp_path):
    _need_cuda()
    w = torch.randn(33, 17, device="cuda").to(torch.bfloat16)
    s = torch.tensor(7, dtype=torch.int32, device="cuda")
    ckpt.save(str(tmp_path), 3, {"w": w, "s": s})
    step, got, _ = ckpt.restore_latest(str(tmp_path), {"w": torch.zeros_like(w),
                                                       "s": torch.zeros_like(s)})
    assert step == 3 and got["w"].device.type == "cuda" and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    assert got["s"].item() == 7


@pytest.mark.cuda
def test_train_cli_runs_on_the_card_by_default(tmp_path, capsys):
    _need_cuda()
    params = train_cli.main(["--arch", "gemma3-4b", "--smoke", "--steps", "2", "--seq-len",
                             "32", "--batch", "2", "--log-every", "1", "--ckpt-dir",
                             str(tmp_path), "--ckpt-every", "2"])
    assert all(t.device.type == "cuda" for t in tree.leaves(params))
    assert "step     2 loss=" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 2
