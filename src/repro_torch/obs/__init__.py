"""repro_torch.obs — observability for the control plane and the fluid engine.

``spans`` records the control plane's lifecycle spans; ``telemetry`` is the
schema and host-side assembly of the fluid engine's in-run telemetry slots
(``simulate_chunked(..., spec=RunSpec(telemetry=S))``); ``ledger``
decomposes ``cpu_overhead`` and ``normalized_memory`` into where the
overhead goes, from both engines.  Copies of ``repro.obs``'s modules (numpy
only; see ``repro.obs`` for the metric each series and span reads).
"""

from repro_torch.obs.ledger import (CPU_COMPONENTS, MEM_COMPONENTS, OverheadLedger,
                                    attribution_table, check_ledger,
                                    ledger_from_chunked, ledger_from_eventsim,
                                    ledger_parity)
from repro_torch.obs.spans import Span, SpanRecorder, validate
from repro_torch.obs.telemetry import (TELEM_ATTR, TELEM_SERIES, RunTelemetry,
                                       assemble_telemetry,
                                       write_oracle_timeline_csv,
                                       write_timeline_csv)

__all__ = [
    "Span", "SpanRecorder", "validate",
    "OverheadLedger", "ledger_from_eventsim", "ledger_from_chunked",
    "ledger_parity", "check_ledger", "attribution_table",
    "CPU_COMPONENTS", "MEM_COMPONENTS",
    "TELEM_SERIES", "TELEM_ATTR", "RunTelemetry", "assemble_telemetry",
    "write_timeline_csv", "write_oracle_timeline_csv",
]
