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
  violation, demotion, SIGUSR2) — zero file I/O in steady state
  (``flightrec.py``).

Nothing here touches the device. The JAX package's ``profile``,
``promexp`` and ``explain`` are not ported yet (ROADMAP Queue 1, item 12).
"""

from . import flightrec, metrics
from .tracing import (ENV_VAR, console_enabled, disable, disable_console,
                      enable, enable_console, enabled, event, event_log_path,
                      notice, obs_dir, reset_enablement, span, validate_event,
                      validate_events_dir, validate_events_file)

__all__ = [
    "ENV_VAR", "console_enabled", "disable", "disable_console", "enable",
    "enable_console", "enabled", "event", "event_log_path", "flightrec",
    "metrics", "notice", "obs_dir", "reset_enablement", "snapshot",
    "reset", "span", "validate_event", "validate_events_dir",
    "validate_events_file",
]


def snapshot():
    """Shorthand for ``metrics.snapshot()``."""
    return metrics.snapshot()


def reset():
    """Shorthand for ``metrics.reset()`` (does not touch enablement)."""
    metrics.reset()
