"""Plain torch version of the grouped expert FFN (SwiGLU per expert).

Counterpart of ``repro.kernels.moe_gemm.ref``: x (E, C, d) the experts'
capacity buffers; wg, wu (E, d, f); wo (E, f, d).
out = (silu(x @ wg) * (x @ wu)) @ wo per expert, in float32 throughout and
cast once to x.dtype.  It is the CPU path of the wrapper and the version the
CUDA kernel is held to on the card.  ``moe_expert_ffn_bf16h_ref`` is the
bf16 kernels' own arithmetic, which they are also held to, more tightly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_expert_ffn_ref(x, wg, wu, wo):
    xf = x.float()
    h = F.silu(torch.bmm(xf, wg.float())) * torch.bmm(xf, wu.float())
    return torch.bmm(h, wo.float()).to(x.dtype)


def moe_expert_ffn_bf16h_ref(x, wg, wu, wo):
    """As the bf16 CUDA kernels compute it: h rounded to x.dtype between the
    two products (a chain of bf16 matmuls rounds it there; the plain version
    keeps it in float32), sums in float64 (the kernels' fp32 sums differ from
    them by reordering only), out rounded once."""
    xd = x.double()
    h = (F.silu(torch.bmm(xd, wg.double())) * torch.bmm(xd, wu.double())).to(x.dtype)
    return torch.bmm(h.double(), wo.double()).to(x.dtype)
