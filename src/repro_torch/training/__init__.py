"""Training (counterpart of ``repro.training``): ``optimizer`` (AdamW),
``data`` (the synthetic, restart-safe pipeline), ``checkpoint`` (step-atomic
saves), ``train_step`` and ``tree`` (nested dict/list trees of tensors).
The submodules' functions are not re-exported here, so that
``training.train_step`` is the module, not the function of the same name;
``opt_specs`` is, as in the JAX package."""
from repro_torch.training.optimizer import opt_specs  # noqa: F401
