"""repro_torch.obs — lifecycle spans for the control plane (see ``spans``)."""

from repro_torch.obs.spans import Span, SpanRecorder, validate

__all__ = ["Span", "SpanRecorder", "validate"]
