"""Training (counterpart of ``repro.training``): ``optimizer`` (AdamW),
``data`` (the synthetic, restart-safe pipeline), ``checkpoint`` (step-atomic
saves), ``train_step`` and ``tree`` (nested dict/list trees of tensors).
The submodules are not re-exported here, so that ``training.train_step`` is
the module, not the function of the same name."""
