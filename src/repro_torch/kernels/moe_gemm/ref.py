"""Plain torch version of the grouped expert FFN (SwiGLU per expert).

Counterpart of ``repro.kernels.moe_gemm.ref``: x (E, C, d) the experts'
capacity buffers; wg, wu (E, d, f); wo (E, f, d).
out = (silu(x @ wg) * (x @ wu)) @ wo per expert, in float32 throughout and
cast once to x.dtype.  It is the CPU path of the wrapper and the version the
CUDA kernel is held to on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_expert_ffn_ref(x, wg, wu, wo):
    xf = x.float()
    h = F.silu(torch.bmm(xf, wg.float())) * torch.bmm(xf, wu.float())
    return torch.bmm(h, wo.float()).to(x.dtype)
