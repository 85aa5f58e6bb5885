"""The port's losses and their gradients held to the JAX package on the CPU.

``layers.cross_entropy``, ``head.loss_from_logits`` and ``head.chunked_loss``
against their JAX counterparts; each family's ``registry.loss_fn`` and its
gradient against ``jax.value_and_grad(repro.models.registry.loss_fn)``, the
weights and the JAX gradient carried across by ``convert.params_from_jax``;
hymba's selective scan and the blocked attention under autograd; the remat
policies; and the kernel wrappers, which are forward only and refuse to be
differentiated (the JAX package's Pallas kernels have no VJP).

Inputs are made from numpy seeds in float32 smoke configs.  Tolerances: rtol
1e-5 on losses, 1e-4 of a leaf's largest entry on gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.flash_attention import ops as jfa_ops
from repro.models import head as jhead
from repro.models import hymba as jhymba
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.training.data import DataConfig, batch_at
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gemm import moe_expert_ffn
from repro_torch.kernels.rwkv6_scan import ops as k4_ops
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models import convert, head, hymba, layers, moe, registry
from repro_torch.training import tree

F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
FAMILIES = ["gemma3-4b", "internvl2-76b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
            "rwkv6-3b", "hymba-1.5b", "whisper-tiny"]


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _cfgs(arch, **over):
    over = {**F32, **over}
    return jax_smoke(arch).replace(**over), get_smoke_config(arch).replace(**over)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed=0):
    jcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, jax.jit(functools.partial(jregistry.init_params, jcfg))(
        jax.random.PRNGKey(seed)))


def _batch(cfg, b=2, s=32, step=1):
    """A packed-document batch of the training pipeline (mask zeros at the
    document boundaries), plus a family's frontend stub."""
    out = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                              mean_doc_len=12), step)
    if cfg.family == "vlm":
        out["patch_embeds"] = _normal((b, cfg.num_patches, cfg.d_model), 7)
    if cfg.family == "encdec":
        out["enc_embeds"] = _normal((b, cfg.encoder_seq, cfg.d_model), 8)
    return out


def _port_loss_and_grads(cfg, params, batch):
    leaves = tree.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, aux = registry.loss_fn(cfg, params, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), aux, tree.unflatten(params, list(grads))


def _assert_grads_close(got, want):
    pairs = list(zip(tree.with_paths(got), tree.with_paths(want)))
    assert len(pairs) == len(tree.leaves(want)) > 0
    for (path, a), (wpath, b) in pairs:
        assert path == wpath
        a, b = a.detach().numpy(), b.detach().numpy()
        scale = float(np.max(np.abs(b)))
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_TOL * scale + 1e-30,
                                   err_msg=str(path))


# -- cross entropy ------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_loss_from_logits_match_jax(masked):
    b, s, v = 2, 9, 37
    lg = _normal((b, s, v), 0, 3.0)
    tg = np.random.default_rng(1).integers(0, v, (b, s)).astype(np.int32)
    mask = (np.random.default_rng(2).random((b, s)) > 0.3).astype(np.float32) if masked else None
    want = jlayers.cross_entropy(jnp.asarray(lg), jnp.asarray(tg),
                                 None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy(_t(lg), _t(tg), None if mask is None else _t(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    batch = {"targets": tg} if mask is None else {"targets": tg, "loss_mask": mask}
    got2 = head.loss_from_logits(_t(lg), {k: _t(x) for k, x in batch.items()})
    want2 = jhead.loss_from_logits(jnp.asarray(lg), {k: jnp.asarray(x) for k, x in batch.items()})
    np.testing.assert_allclose(got2.item(), float(want2), rtol=LOSS_RTOL)


def test_cross_entropy_of_an_all_zero_mask_is_zero():
    lg = _t(_normal((1, 4, 5), 3))
    got = layers.cross_entropy(lg, torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1, 4)))
    assert got.item() == 0.0


@pytest.mark.parametrize("s,chunk,softcap,tie", [
    (24, 512, None, True),     # one chunk
    (24, 8, None, True),       # three chunks
    (30, 8, 5.0, False),       # 30 % 8: chunks of 6 (largest divisor <= 8), softcap, lm_head
])
def test_chunked_loss_and_its_grads_match_jax(s, chunk, softcap, tie):
    arch = "gemma3-4b"
    jcfg, cfg = _cfgs(arch, final_logit_softcap=softcap, tie_embeddings=tie)
    jp = jax.tree.map(np.asarray, jax.jit(functools.partial(jhead.init, jcfg))(
        jax.random.PRNGKey(3)))
    x = _normal((2, s, cfg.d_model), 4)
    batch = _batch(cfg, s=s)

    def jloss(p, x):
        return jhead.chunked_loss(jcfg, p, x, {k: jnp.asarray(v) for k, v in batch.items()},
                                  chunk=chunk)
    want, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    p = {k: _t(v, True) for k, v in jp.items()}
    xt = _t(x, True)
    got = head.chunked_loss(cfg, p, xt, {k: _t(v) for k, v in batch.items()}, chunk=chunk)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    grads = torch.autograd.grad(got, [*p.values(), xt], allow_unused=True, materialize_grads=True)
    _assert_grads_close(dict(zip([*p, "x"], grads)),
                        {**{k: _t(np.asarray(jgp[k])) for k in p}, "x": _t(np.asarray(jgx))})
    # the same number as the cross entropy of the full logits
    full = layers.cross_entropy(head.logits(cfg, p, xt), _t(batch["targets"]),
                                _t(batch["loss_mask"]))
    np.testing.assert_allclose(got.item(), full.item(), rtol=LOSS_RTOL)


# -- each family's loss and its gradient ------------------------------------------------


class _RouteMargins:
    """Records, for every moe layer the loss runs, the smallest gap between a
    token's k-th and (k+1)-th router probability: a gap far above the two
    packages' float32 differences means no expert set can flip."""

    def __init__(self, monkeypatch):
        self.gaps = []
        route = moe._route

        def recording(cfg, p, xg):
            out = route(cfg, p, xg)
            top = torch.topk(torch.softmax(xg.float() @ p["router"], -1), cfg.top_k + 1, -1)[0]
            self.gaps.append((top[..., -2] - top[..., -1]).min().item())
            return out
        monkeypatch.setattr(moe, "_route", recording)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_grads_match_jax(arch, monkeypatch):
    jcfg, cfg = _cfgs(arch)
    jp = _jax_params(arch)
    batch = _batch(cfg)
    margins = _RouteMargins(monkeypatch) if cfg.family == "moe" else None
    (want, jaux), jg = jax.jit(jax.value_and_grad(functools.partial(jregistry.loss_fn, jcfg),
                                                  has_aux=True))(
        jax.tree.map(jnp.asarray, jp), {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux, grads = _port_loss_and_grads(cfg, convert.params_from_jax(cfg, jp), batch)
    if margins is not None:
        # seed 0 and step 1 keep every top-k choice well clear of a tie
        assert len(margins.gaps) == cfg.num_layers - cfg.first_dense_layers
        assert min(margins.gaps) > 1e-4, margins.gaps
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=LOSS_RTOL)
    _assert_grads_close(grads, convert.params_from_jax(cfg, jax.tree.map(np.asarray, jg)))


def test_loss_fn_covers_every_family():
    fams = {get_smoke_config(a).family for a in FAMILIES}
    assert fams == {"dense", "vlm", "moe", "ssm", "hybrid", "encdec"}
    for a in FAMILIES:
        assert callable(registry.family_module(get_smoke_config(a)).loss_fn)


# -- pieces under autograd ------------------------------------------------------------------


def test_selective_scan_grads_match_jax_scan():
    """Across two of selective_scan's blocks (300 tokens), from a non-zero h0:
    the port's stacked states under autograd against JAX's lax.scan gradient."""
    b, s, di, n = 2, 300, 6, 4
    dt = np.abs(_normal((b, s, di), 10, 0.1))
    a = -np.abs(_normal((di, n), 11))
    bb, cc, xc = _normal((b, s, n), 12), _normal((b, s, n), 13), _normal((b, s, di), 14)
    d, h0 = _normal((di,), 15), _normal((b, di, n), 16)
    w = _normal((b, s, di), 17)            # a random cotangent on y
    wh = _normal((b, di, n), 18)           # and on the last state
    args = (dt, a, bb, cc, xc, d, h0)

    (jy, jh), vjp = jax.vjp(jhymba.selective_scan, *map(jnp.asarray, args))
    jgrads = vjp((jnp.asarray(w), jnp.asarray(wh)))
    ts = [_t(x, True) for x in args]
    y, h = hymba.selective_scan(*ts)
    _assert_grads_close({"y": y, "h": h}, {"y": _t(np.asarray(jy)), "h": _t(np.asarray(jh))})
    grads = torch.autograd.grad((y, h), ts, (_t(w), _t(wh)))
    names = ["dt", "a", "b", "c", "xc", "d", "h0"]
    _assert_grads_close(dict(zip(names, grads)),
                        {k: _t(np.asarray(g)) for k, g in zip(names, jgrads)})


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("s,ops", [(1, 34), (300, 1259)])
def test_selective_scan_serving_path_keeps_its_op_count(s, ops):
    """A CPU-countable proxy of hymba's launches: the aten ops of one
    selective_scan call when nothing requires grad (a decode step's S 1 and a
    prefill's two blocks) are those of the form before the autograd repair,
    which wrote each state into a preallocated block, one addcmul a token."""
    b, di, n = 2, 8, 4
    xs = [_t(np.abs(_normal((b, s, di), 20, 0.1))), _t(-np.abs(_normal((di, n), 21))),
          _t(_normal((b, s, n), 22)), _t(_normal((b, s, n), 23)), _t(_normal((b, s, di), 24)),
          _t(np.ones(di, np.float32)), _t(np.zeros((b, di, n), np.float32))]
    for ctx in (torch.no_grad(), torch.enable_grad()):
        with ctx, _CountOps() as count:
            hymba.selective_scan(*xs)
        assert count.n == ops


@pytest.mark.parametrize("s,window,q_block", [(48, None, 16), (48, 20, 16), (40, None, 512)])
def test_blocked_attention_grads_match_jax(s, window, q_block):
    """layers.attention under autograd (each query block checkpointed)
    against the JAX package's (@jax.checkpoint over a lax.scan of blocks)."""
    b, h, k, d = 2, 4, 2, 16
    q, kk, v = _normal((b, s, h, d), 30), _normal((b, s, k, d), 31), _normal((b, s, k, d), 32)
    w = _normal((b, s, h, d), 33)

    def jf(q, k, v):
        return jlayers.attention(q, k, v, causal=True, window=window, q_block=q_block)
    want, vjp = jax.vjp(jf, *map(jnp.asarray, (q, kk, v)))
    ts = [_t(x, True) for x in (q, kk, v)]
    got = layers.attention(*ts, causal=True, window=window, q_block=q_block)
    _assert_grads_close({"out": got}, {"out": _t(np.asarray(want))})
    grads = torch.autograd.grad(got, ts, _t(w))
    jg = vjp(jnp.asarray(w))
    _assert_grads_close(dict(zip("qkv", grads)), {n: _t(np.asarray(g)) for n, g in zip("qkv", jg)})
    # and without autograd, the preallocated form gives the same output
    with torch.no_grad():
        plain = layers.attention(*[t.detach() for t in ts], causal=True, window=window,
                                 q_block=q_block)
    torch.testing.assert_close(plain, got.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-moe-16b", "hymba-1.5b", "whisper-tiny"])
def test_remat_policies_give_the_same_grads(arch):
    """remat none, full and dots: the same loss and gradients (the recomputed
    forward is the same arithmetic on the same inputs)."""
    _, cfg = _cfgs(arch)
    jp = _jax_params(arch)
    batch = _batch(cfg)
    base_loss, _, base = _port_loss_and_grads(cfg, convert.params_from_jax(cfg, jp), batch)
    for remat in ("full", "dots"):
        c = cfg.replace(remat=remat)
        loss, _, grads = _port_loss_and_grads(c, convert.params_from_jax(c, jp), batch)
        assert loss.item() == base_loss.item()
        for a, b in zip(tree.leaves(grads), tree.leaves(base)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the kernels are forward only ----------------------------------------------------------


def _kernel_calls():
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g)
    q, k, v = rand(1, 4, 4, 16), rand(1, 4, 2, 16), rand(1, 4, 2, 16)
    pos = torch.tensor([3], dtype=torch.int32)
    x, wg, wu, wo = rand(2, 4, 8), rand(2, 8, 16), rand(2, 8, 16), rand(2, 16, 8)
    r, kr, vr, lw, u = rand(1, 5, 2, 16), rand(1, 5, 2, 16), rand(1, 5, 2, 16), \
        -rand(1, 5, 2, 16).abs(), rand(2, 16)
    return [
        ("flash_attention", lambda t: flash_attention(*t), [q, k, v]),
        ("decode_attention", lambda t: decode_attention(t[0][:, :1], t[1], t[2], pos),
         [q, k, v]),
        ("moe_expert_ffn", lambda t: moe_expert_ffn(*t), [x, wg, wu, wo]),
        ("rwkv6_scan", lambda t: rwkv6_scan(*t), [r, kr, vr, lw, u]),
        ("rwkv6_scan", lambda t: k4_ops._launch(*t, None, k4_ops.SEGMENT), [r, kr, vr, lw, u]),
    ]


@pytest.mark.parametrize("i", range(5), ids=["K2", "K1", "K3", "K4", "K4._launch"])
def test_kernel_wrappers_refuse_grad_on_cpu(i):
    name, call, inputs = _kernel_calls()[i]
    for j in range(len(inputs)):
        ts = [t.clone().requires_grad_(n == j) for n, t in enumerate(inputs)]
        with pytest.raises(RuntimeError, match=f"{name} is a forward-only kernel.*attn_impl=\"ref\""):
            call(ts)
        with torch.no_grad():      # no grad mode: the plain version runs
            if i < 4:
                call(ts)


def test_a_loss_under_attn_impl_kernel_raises():
    for arch in ("gemma3-4b", "deepseek-moe-16b", "rwkv6-3b", "hymba-1.5b"):
        _, cfg = _cfgs(arch, attn_impl="kernel")
        params = registry.init_params(cfg, device="cpu", seed=0)
        with pytest.raises(RuntimeError, match="forward-only kernel"):
            _port_loss_and_grads(cfg, params, _batch(cfg))


def test_jax_kernel_is_forward_only_too():
    """The reference refuses as well: jax.grad through the Pallas flash
    attention (interpret mode) raises."""
    q = jnp.asarray(_normal((1, 16, 2, 16), 40))

    def f(q):
        return jnp.sum(jfa_ops.flash_attention(q, q, q, causal=True, interpret=True))
    with pytest.raises(AssertionError):
        jax.grad(f)(q)
