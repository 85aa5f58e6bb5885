"""PyTorch/CUDA port of ``repro``: the same system, run on an NVIDIA GPU.

Imports torch and numpy only, never jax and never ``repro``.  See README.md
in this directory for the layout and the device rule.
"""
