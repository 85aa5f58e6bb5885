"""Shared helpers of the scenario layer's CPU parity tests (not a test module).

What the port's CLIs print is held to what the JAX package's print with the
comparator that ``chip_smoke.py`` holds them with on the card
(``repro_torch.launch.clitext``): text equal but for its numbers, each within
``CLI_RTOL`` or one unit of its last printed digit (``same_text``), CSV
compared without its ``wall_s`` column (``without_walls``).
"""

import math

from repro_torch.launch.clitext import same_text, without_walls  # noqa: F401

CLI_RTOL = 1e-3          # tests/data/torch_scenario_jax_rows.json's cli_rtol


def same_value(a, b) -> bool:
    """Equal, with NaN equal to NaN (an oracle row's nodes_mean without a fleet)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b
