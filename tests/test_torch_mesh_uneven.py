"""The port's model families on meshes that do not fit the smoke widths, with
real collectives (gloo, one process a rank: ``torch_mesh_common``), held to
the unsharded port in float32:

* a (1, 3) ("data", "model") mesh, whose "model" axis of 3 divides none of
  the smoke configs' heads, kv heads, FFN or vocabulary widths, so that
  ``sanitize_spec`` drops it from every such spec (and a 24-deep full cache
  is split over it by ``kv_seq``);
* a (2, 2, 2) ("pod", "data", "model") mesh for gemma3-4b: the batch axis
  over two mesh axes;
* the moe families' sort-based dispatch (``moe_impl="ragged"``) on the
  (4, 2) mesh of ``tests/test_torch_mesh_models.py``.
"""

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from torch_mesh_common import run_mesh

ARCHS = ("gemma3-4b", "internvl2-76b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
         "rwkv6-3b", "hymba-1.5b", "whisper-tiny")
RUN = dict(batch=4, seq=22, decode_steps=2, seed=1)
CALLS = ("forward", "prefill", "decode0", "decode1")
TOL = 1e-5     # of the largest magnitude, as tests/test_torch_mesh_models.py
MOE = ("deepseek-moe-16b", "deepseek-v2-lite-16b")


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * float(np.max(np.abs(want))) + 1e-30, err_msg=msg)


@pytest.fixture(scope="module")
def uneven():
    return run_mesh(dict(archs=list(ARCHS), mesh=[[1, 3], ["data", "model"]], **RUN),
                    timeout=600)


@pytest.fixture(scope="module")
def pod():
    return run_mesh(dict(archs=["gemma3-4b"], mesh=[[2, 2, 2], ["pod", "data", "model"]],
                         **RUN), timeout=600)


@pytest.fixture(scope="module")
def ragged():
    return run_mesh(dict(archs=list(MOE), mesh=[[4, 2], ["data", "model"]],
                         overrides={"moe_impl": "ragged"}, **RUN), timeout=600)


def test_the_model_axis_divides_no_smoke_width():
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        widths = [cfg.num_heads, cfg.d_ff, cfg.vocab_size, cfg.d_model]
        if cfg.num_kv_heads:
            widths.append(cfg.num_kv_heads)
        assert all(w % 3 for w in widths), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_a_non_dividing_mesh_equals_the_unsharded_port(uneven, arch):
    r = uneven[arch]
    for call in CALLS:
        assert np.isfinite(r["mesh"][call]).all(), call
        _close(r["mesh"][call], r["ref"][call], msg=call)


def test_a_pod_mesh_equals_the_unsharded_port(pod):
    r = pod["gemma3-4b"]
    for call in CALLS:
        _close(r["mesh"][call], r["ref"][call], msg=call)


@pytest.mark.parametrize("arch", MOE)
def test_sort_based_dispatch_on_a_mesh_equals_the_unsharded_port(ragged, arch):
    r = ragged[arch]
    for call in CALLS:
        _close(r["mesh"][call], r["ref"][call], msg=call)
