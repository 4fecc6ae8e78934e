"""Structured observability of the port — the host core of the JAX
package's ``obs/``: spans, metrics and the flight recorder.

* ``obs.span("plan.build") / obs.event / obs.notice`` — host-side span
  tracing into a per-run JSONL event log under ``$DFFT_OBS_DIR`` (default
  off), with ``torch.profiler.record_function`` mirroring the names into
  profiler traces (``tracing.py``).
* ``obs.metrics`` — process-global counters/gauges/latency histograms
  with per-plan vs cumulative views (``metrics.py``).
* ``obs.flightrec`` — the ALWAYS-ON bounded in-memory ring of recent
  spans/events/metric deltas, dumped to JSONL on trigger (guard
  violation, demotion, circuit open, shed burst, SIGUSR2) — zero file
  I/O in steady state (``flightrec.py``).
* ``obs.promexp`` — Prometheus text exposition of the cumulative metrics
  view; ``dfft-torch-serve --http`` serves it at ``GET /metrics``
  (``promexp.py``).
* ``obs.profile`` — stage-attributed device profiling: the plan families
  wrap each declared plan-graph node in
  ``torch.profiler.record_function("dfft/<family>/<node-id>")``, a trace
  reader for ``torch.profiler``'s chrome traces (and the JAX package's
  xplane files), and ``capture_stage_profile``, which runs one direction
  of a live plan under ``torch.profiler`` and charges its device time to
  those scopes, and ``stage_profile``, which joins that time onto the
  declared plan graph with each stage's H100 ideal (``profile.py``).
* ``dfft-torch-explain`` — resolved-plan diagnostics (``explain.py``).
"""

from . import flightrec, metrics, profile, promexp
from .tracing import (ENV_VAR, console_enabled, disable, disable_console,
                      enable, enable_console, enabled, event, event_log_path,
                      notice, obs_dir, reset_enablement, span, validate_event,
                      validate_events_dir, validate_events_file)

__all__ = [
    "ENV_VAR", "console_enabled", "disable", "disable_console", "enable",
    "enable_console", "enabled", "event", "event_log_path", "flightrec",
    "metrics", "notice", "obs_dir", "profile", "promexp",
    "reset_enablement", "snapshot",
    "reset", "span", "validate_event", "validate_events_dir",
    "validate_events_file",
]


def snapshot():
    """Shorthand for ``metrics.snapshot()``."""
    return metrics.snapshot()


def reset():
    """Shorthand for ``metrics.reset()`` (does not touch enablement)."""
    metrics.reset()
