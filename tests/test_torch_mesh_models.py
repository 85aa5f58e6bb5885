"""Every model family of the port on DTensor parameters over a (4, 2)
("data", "model") mesh, with real collectives (gloo, one process a rank:
``torch_mesh_common``), held to the unsharded port and to the JAX package's
sharded run of the same weights on 8 forced host devices
(``torch_dist_common``'s ``model_mesh`` job), in float32 at smoke size.

Both sides start at once: the JAX subprocess and the 8 ranks.  The weights
are the JAX package's seeded init, carried across (``convert``), so that the
port's and JAX's runs compute on the same numbers; the ranks also run
gemma3-4b's ``loss_fn`` and its gradients on the mesh.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import registry as jregistry
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert
from torch_dist_common import start_jax_jobs
from torch_mesh_common import F32, run_mesh

ARCHS = ("gemma3-4b", "internvl2-76b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
         "rwkv6-3b", "hymba-1.5b", "whisper-tiny")
FAMILIES = {"dense", "vlm", "moe", "ssm", "hybrid", "encdec"}
MESH = [[4, 2], ["data", "model"]]
# seq 22 + 2 decode steps: the smoke configs' 16-slot ring caches wrap
RUN = dict(batch=4, seq=22, decode_steps=2, seed=0)
# outputs within 1e-5 of their largest magnitude (the models' ``_rel_err``
# measure): a sharded matmul sums in another order, and an output near zero
# keeps an absolute, not a relative, rounding of the logits' scale
TOL = 1e-5
GRAD_TOL = 1e-4          # tests/test_torch_losses.py's, also of the largest magnitude
# rwkv6-3b's one-token decode steps against JAX's sharded run: within 1e-3 of the
# largest logit, chip_smoke.py's float32 bound for rwkv6-3b (F32_LOGITS_BOUND): the
# recurrence carries the sums' float32 rounding from step to step (3.0e-5 at the
# first step here, 1.75e-4 at the second; the port's own sharded run holds 1e-5)
JAX_TOL = {("rwkv6-3b", "decode0"): 1e-3, ("rwkv6-3b", "decode1"): 1e-3}
CALLS = ("forward", "prefill", "decode0", "decode1")
# gemma3-4b, and the two families whose scans run on local shards
LOSS = ("gemma3-4b", "rwkv6-3b", "hymba-1.5b")


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.max(np.abs(want))) + 1e-30, err_msg=msg)


def _jax_params(arch: str, path) -> str:
    jcfg = jax_smoke(arch).replace(**F32)
    tree = jax.jit(functools.partial(jregistry.init_params, jcfg))(
        jax.random.PRNGKey(RUN["seed"]))
    params = convert.params_from_jax(get_smoke_config(arch).replace(**F32),
                                     jax.tree.map(np.asarray, tree))
    torch.save(params, path)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    wait = start_jax_jobs([dict(kind="model_mesh", archs=list(ARCHS), mesh=MESH,
                                out=str(tmp / "jax.npz"), **RUN)])
    params = {a: _jax_params(a, tmp / f"{a}.pt") for a in ARCHS}
    port = run_mesh(dict(archs=list(ARCHS), mesh=MESH, params=params,
                         loss=list(LOSS), **RUN), timeout=600)
    (res,) = wait(600)
    return port, dict(np.load(res["path"]))


def test_the_archs_cover_every_family():
    assert {get_smoke_config(a).family for a in ARCHS} == FAMILIES
    assert get_smoke_config("deepseek-v2-lite-16b").use_mla


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_port_equals_the_unsharded_port(runs, arch):
    port, _ = runs
    r = port[arch]
    for call in CALLS:
        assert np.isfinite(r["mesh"][call]).all(), call
        _close(r["mesh"][call], r["ref"][call], msg=call)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_port_equals_jax_s_sharded_run(runs, arch):
    port, jx = runs
    r = port[arch]
    # the greedy tokens fed to the decode steps agree
    fed = np.concatenate([r["ref"]["forward"][:, -1:].argmax(-1),
                          r["ref"]["decode0"][:, -1:].argmax(-1)], axis=1)
    np.testing.assert_array_equal(fed, jx[f"{arch}/feed"])
    for call in CALLS:
        _close(r["mesh"][call], jx[f"{arch}/{call}"], JAX_TOL.get((arch, call), TOL), call)


@pytest.mark.parametrize("arch", LOSS)
def test_loss_and_gradients_on_the_mesh(runs, arch):
    port, _ = runs
    r = port[arch]
    np.testing.assert_allclose(r["loss_mesh"], r["loss_ref"], rtol=1e-5)
    assert len(r["grads_mesh"]) == len(r["grads_ref"]) > 10
    for gm, gr in zip(r["grads_mesh"], r["grads_ref"]):
        assert gm.shape == gr.shape
        _close(gm, gr, GRAD_TOL)
