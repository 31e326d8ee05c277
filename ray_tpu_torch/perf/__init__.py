"""Performance-introspection plane (ISSUE 17).

Three coupled pieces, built so the next perf arc (overlap-scheduled
collectives, chunked prefill, kernel speed) has something to aim at and
something to prove with:

- :mod:`ray_tpu_torch.perf.recorder` — the flight recorder: an always-on,
  bounded, lock-light per-process ring of structured runtime events
  (cgraph op begin/end, channel send/recv seq, engine admissions and
  preemptions, dispatch decisions). Overhead is one attribute test when
  disabled and a deque append + dict build when enabled; the measured
  bar lives in bench rows (``profiler_overhead_pct``) and is asserted
  CPU-count-aware in tests.
- :mod:`ray_tpu_torch.perf.report` — :class:`StepReport`: the structured
  result of ``CompiledPipelineEngine.profile()`` /
  ``LLMEngine.profile()``, with per-stage exec/bubble/recv/sync
  breakdowns, MFU, chrome-trace export, and microbatch tuning hints.
- :mod:`ray_tpu_torch.perf.postmortem` — merged driver+worker bundle dumps
  triggered by every abort path, rendered by ``ray_tpu_torch postmortem``.
- :mod:`ray_tpu_torch.perf.snapshot` — the one head RPC feeding
  ``ray_tpu_torch top``.

docs/OBSERVABILITY.md "Profiling & post-mortem" is the schema
reference.
"""
from .recorder import (FlightRecorder, get_recorder, record,  # noqa: F401
                       recorder_enabled, set_enabled)
from .report import (StepReport, analytic_bubble_frac,  # noqa: F401
                     compute_mfu)
from .postmortem import (dump_bundle, last_bundle_path,  # noqa: F401
                         load_bundle, render_bundle)

__all__ = [
    "FlightRecorder", "get_recorder", "record", "recorder_enabled",
    "set_enabled", "StepReport", "analytic_bubble_frac", "compute_mfu",
    "dump_bundle", "last_bundle_path", "load_bundle", "render_bundle",
]
