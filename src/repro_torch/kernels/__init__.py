# Hand-written CUDA kernels for Hopper, each beside its plain torch version.
"""The kernels are forward only, as the JAX package's Pallas kernels are (no
VJP): a wrapper that autograd would have to differentiate raises
(``refuse_grad``) on every device, so that a loss taken through a kernel can
never backpropagate a silent zero.  Training runs ``attn_impl="ref"``.  A
wrapper also raises on a DTensor (``refuse_dtensor``): a kernel takes a
rank's local shards (``sharding.local_map``), never a DTensor that it would
have to read whole or turn to its plain version.
"""

import torch


def refuse_dtensor(kernel: str, *tensors) -> None:
    """Raise ``TypeError`` when an input of ``kernel`` is a DTensor (None
    entries are skipped)."""
    from repro_torch.distributed.sharding import is_dtensor
    if any(t is not None and is_dtensor(t) for t in tensors):
        raise TypeError(f"{kernel} takes plain tensors, not DTensors: call it on the "
                        f"local shards (repro_torch.distributed.sharding.local_map)")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when grad mode is on and a floating input of ``kernel`` requires
    grad (None entries are skipped)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.is_floating_point() and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} is a forward-only kernel and cannot be "
                           f"differentiated; train with attn_impl=\"ref\"")
