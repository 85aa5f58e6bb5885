"""The card's constants for the dry run's roofline terms: one NVIDIA H100 SXM
(``NVIDIA H100 80GB HBM3``, 700 W power limit), the card the port runs on.

Each is NVIDIA's data-sheet figure.  ``chip_smoke.py``'s ``dryrun.constants``
phase measures the first two on the card and fails if a reading exceeds its
constant by more than 5% (an impossible reading, so a wrong constant).
"""

#: dense bf16 tensor-core FLOP/s (data sheet, without sparsity).  Measured:
#: a bf16 torch.matmul of 8192^3, median of 20 after warm-up (chip_smoke.py
#: dryrun.constants; PERF.md §6 gives the reading with the card's power limit)
PEAK_FLOPS = 989e12

#: HBM3 bytes/s (data sheet).  Measured: a 2 GiB device-to-device copy,
#: read plus write bytes over its time (chip_smoke.py dryrun.constants)
HBM_BW = 3.35e12

#: NVLink 4 bytes/s in one direction (data sheet: 900 GB/s both ways over
#: 18 links).  Not measured: a run sees one card, so no link is in use
LINK_BW = 450e9

#: the card these figures are of, as ``nvidia-smi --query-gpu=name,power.limit``
#: prints it
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
