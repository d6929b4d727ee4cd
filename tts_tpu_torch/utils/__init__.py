from .timing import StageTimer, SynthesisReport, trace_profile

__all__ = ["StageTimer", "SynthesisReport", "trace_profile"]
