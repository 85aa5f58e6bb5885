"""The op-level cost model (``repro_torch.launch.op_analysis``): the
counterpart of ``tests/test_distributed.py``'s HLO analyzer tests, on eager
ops.  Matmul FLOPs are ``FlopCounterMode``'s; a Python loop counts each
iteration; views are free; a backward is counted; the live bytes' peak
follows allocations and frees; a write into a slice is charged at the slice.
"""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.op_analysis import OpCounter, analyze, breakdown

F32 = 4


def _flop_counter(fn, *args) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


MATMULS = {
    "mm": (lambda a, b: a @ b, [(64, 32), (32, 16)], 2 * 64 * 32 * 16),
    "bmm": (torch.bmm, [(3, 8, 5), (3, 5, 7)], 2 * 3 * 8 * 5 * 7),
    "addmm": (lambda c, a, b: torch.addmm(c, a, b), [(16,), (8, 12), (12, 16)], 2 * 8 * 12 * 16),
    "einsum": (lambda a, b: torch.einsum("bhtd,bhsd->bhts", a, b),
               [(2, 3, 6, 4), (2, 3, 5, 4)], 2 * 2 * 3 * 6 * 5 * 4),
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", list(MATMULS))
def test_a_matmul_counts_2mnk_and_its_operands(name, device):
    fn, shapes, flops = MATMULS[name]
    args = [torch.randn(s).to(device) for s in shapes]
    r = analyze(fn, *args)
    assert r["matmul_flops"] == flops == _flop_counter(fn, *args)
    if name in ("mm", "bmm"):
        out = fn(*args)
        assert r["flops_per_device"] == flops and r["ops"] == 1
        assert r["bytes_per_device"] == sum(a.numel() for a in args) * F32 + out.numel() * F32
        assert r["output_bytes"] == out.numel() * F32
        assert r["argument_bytes"] == sum(a.numel() for a in args) * F32


def test_a_loop_counts_every_iteration():
    x, w = torch.randn(16, 16, device="meta"), torch.randn(16, 16, device="meta")

    def f(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x
    r = analyze(f, x, w)
    assert r["matmul_flops"] == 15 * 2 * 16 ** 3 == _flop_counter(f, x, w)
    assert r["ops"] == 15


def test_views_are_free():
    x = torch.randn(4, 6, 8, device="meta")

    def f(x):
        return x.view(24, 8).t().transpose(0, 1)[1:3].unsqueeze(0).expand(5, 2, 8) \
            .permute(2, 0, 1).detach()
    r = analyze(f, x)
    assert r["ops"] == 0 and r["bytes_per_device"] == 0 and r["flops_per_device"] == 0
    assert r["temp_bytes"] == 0 and r["output_bytes"] == 0


def test_elementwise_and_reductions():
    x = torch.randn(8, 32, device="meta")
    r = analyze(lambda x: torch.exp(x), x)
    assert r["flops_per_device"] == 8 * 32 and r["bytes_per_device"] == 2 * 8 * 32 * F32
    r = analyze(lambda x: x.sum(-1), x)
    assert r["flops_per_device"] == 8 * 32 and r["bytes_per_device"] == (8 * 32 + 8) * F32
    r = analyze(lambda x: x.clone(), x)                    # moves data, computes nothing
    assert r["flops_per_device"] == 0 and r["bytes_per_device"] == 2 * 8 * 32 * F32


def test_a_backward_is_counted():
    x = torch.randn(32, 64, device="meta")
    w = torch.randn(64, 16, device="meta", requires_grad=True)

    def f(x, w):
        y = (x @ w).sum()
        return torch.autograd.grad(y, w)[0]
    r = analyze(f, x, w)
    # the forward mm, and the backward's one for w's grad (x needs none)
    assert r["matmul_flops"] == 2 * (2 * 32 * 64 * 16) == _flop_counter(f, x, w)
    assert r["output_bytes"] == 64 * 16 * F32


def test_the_peak_of_allocations_and_frees():
    x = torch.empty(1000, device="meta")                   # 4,000 bytes held

    def f(x):
        a = torch.zeros(2000, device="meta")               # live 4,000 + 8,000
        b = torch.zeros(500, device="meta")                # + 2,000 = 14,000
        del a                                              # 6,000
        c = torch.zeros(1500, device="meta")               # 12,000
        d = c[:100]                                        # a view: nothing new
        del c                                              # its storage lives on in d
        e = torch.zeros(100, device="meta")                # 12,400
        return b, d, e
    counter = OpCounter()
    assert counter.hold(x) == 4000
    with counter:
        out = f(x)
    assert counter.peak_bytes == 14_000 and counter.live_bytes == 12_400
    del out
    assert counter.live_bytes == 4000
    r = analyze(f, x)
    assert (r["peak_bytes"], r["temp_bytes"], r["argument_bytes"]) == (14_000, 10_000, 4000)
    assert r["output_bytes"] == (500 + 1500 + 100) * F32


def test_writes_into_a_slice_are_charged_at_the_slice():
    buf = torch.empty(64, 128, 256, device="meta")
    src = torch.randn(128, 256, device="meta")
    slice_bytes = 128 * 256 * F32

    r = analyze(lambda b, s: b[3].copy_(s), buf, src)      # read the source, write the slice
    assert r["bytes_per_device"] == 2 * slice_bytes and r["ops"] == 1
    r = analyze(lambda b, s: torch.mul(s, s, out=b[5]), buf, src)
    assert r["bytes_per_device"] == 3 * slice_bytes        # two reads, the slice written
    r = analyze(lambda b, s: b[7].add_(s), buf, src)       # in place: the slice read too
    assert r["bytes_per_device"] == 3 * slice_bytes

    def put(b, s):
        b[torch.tensor([1, 4], device="meta")] = s.expand(2, 128, 256)
    r = analyze(put, buf, src)
    idx = 2 * 8
    assert r["bytes_per_device"] == 2 * (2 * slice_bytes) + idx    # twice the update
    r = analyze(lambda b: b[torch.tensor([2, 9], device="meta")], buf)
    assert r["bytes_per_device"] == 2 * (2 * slice_bytes) + idx    # a gather: twice its output


def test_host_scalars_are_not_counted_on_the_device():
    x = torch.randn(8, device="meta")

    def f(x):
        s = torch.tensor(2.0).item()                       # the host's, as head.embed does
        return x * s
    r = analyze(f, x)
    assert r["ops"] == 1 and r["flops_per_device"] == 8


def test_breakdown_ranks_by_the_key_it_is_given():
    a, b = torch.randn(256, 256, device="meta"), torch.randn(256, 8, device="meta")
    n = 256 * 256

    def f(a, b):
        return a @ a, a.exp() + a.sin() + a.cos(), a @ b
    r = analyze(f, a, b, sites=True)
    # outside the port's modules the calling site is "?"
    mm_flops = 2 * 256 ** 3 + 2 * 256 * 256 * 8
    assert breakdown(r["counts"], top=2, key="flops") == [(mm_flops, "mm:?"), (2 * n, "add:?")]
    mm_bytes = (3 * n + n + 2 * 256 * 8) * F32
    assert breakdown(r["counts"], key="bytes") == [
        (6 * n * F32, "add:?"), (mm_bytes, "mm:?"), (2 * n * F32, "sin:?"),
        (2 * n * F32, "exp:?"), (2 * n * F32, "cos:?")]
    assert breakdown(r["counts"], top=2, key="ops") == [(2, "mm:?"), (2, "add:?")]
    with pytest.raises(KeyError):
        breakdown(r["counts"], key="seconds")


def test_breakdown_names_the_port_s_calling_site():
    from repro_torch.models import layers
    x, w = torch.randn(4, 64, device="meta"), torch.ones(64, device="meta")
    r = analyze(lambda x, w: layers.rmsnorm(x, w, 1e-6), x, w, sites=True)
    tags = [t for _, t in breakdown(r["counts"], key="ops")]
    assert tags and all(t.split(":", 1)[1] == "models/layers.py:rmsnorm" for t in tags)
