# Hand-written CUDA kernels for Hopper, each beside its plain torch version.
"""The kernels are forward only, as the JAX package's Pallas kernels are (no
VJP): a wrapper that autograd would have to differentiate raises
(``refuse_grad``) on every device, so that a loss taken through a kernel can
never backpropagate a silent zero.  Training runs ``attn_impl="ref"``."""

import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when grad mode is on and a floating input of ``kernel`` requires
    grad (None entries are skipped)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.is_floating_point() and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} is a forward-only kernel and cannot be "
                           f"differentiated; train with attn_impl=\"ref\"")
