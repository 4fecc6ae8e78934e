"""When to checkpoint: the ``CheckpointPolicy`` every persistence
surface of the port resolves (the JAX package's ``persist/policy.py``).

A resident simulation wants three triggers, composable:

* **every-N-steps** — bounded re-computation after a crash (the
  replacement worker re-runs at most N-1 steps);
* **every-T-seconds** — bounded wall-clock loss for slow-stepping runs;
* **on-drain** — the graceful-shutdown path (SIGTERM / fleet
  scale-down / ``Server.close(drain=True)``) writes a final generation
  so a PLANNED restart resumes at the exact step it stopped.

Spec grammar (CLI ``--checkpoint-policy`` / ``$DFFT_CKPT_POLICY``),
strict like the fault-spec parser — a policy that silently parsed as
"never checkpoint" would vacuously pass every durability drill::

    steps:N[,secs:T][,drain:on|off]

    steps:10             # every 10 steps (+ the default drain:on)
    secs:30              # every 30 s
    steps:50,secs:60     # whichever comes first
    drain:off            # only explicit saves

Empty/unset resolves to the default: periodic triggers off,
``drain:on``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Resolved checkpoint cadence (see module docstring)."""

    every_steps: Optional[int] = None
    every_s: Optional[float] = None
    on_drain: bool = True

    @classmethod
    def parse(cls, spec: Optional[str]) -> "CheckpointPolicy":
        """Parse the strict grammar above; ``None``/empty -> default.
        Raises ``ValueError`` on anything malformed."""
        if spec is None or not str(spec).strip():
            return cls()
        every_steps: Optional[int] = None
        every_s: Optional[float] = None
        on_drain = True
        seen = set()
        for tok in str(spec).split(","):
            tok = tok.strip()
            if not tok:
                raise ValueError(
                    f"empty element in checkpoint policy {spec!r}")
            key, sep, val = tok.partition(":")
            key = key.strip().lower()
            if not sep or key in seen:
                raise ValueError(
                    f"checkpoint policy wants unique key:value tokens "
                    f"(steps:N, secs:T, drain:on|off), got {tok!r}")
            seen.add(key)
            if key == "steps":
                every_steps = int(val)
                if every_steps < 1:
                    raise ValueError(f"steps must be >= 1, got {val!r}")
            elif key == "secs":
                every_s = float(val)
                if every_s <= 0:
                    raise ValueError(f"secs must be > 0, got {val!r}")
            elif key == "drain":
                v = val.strip().lower()
                if v not in ("on", "off"):
                    raise ValueError(f"drain wants on|off, got {val!r}")
                on_drain = v == "on"
            else:
                raise ValueError(f"unknown checkpoint-policy key {key!r} "
                                 "(choose from steps, secs, drain)")
        return cls(every_steps, every_s, on_drain)

    def __str__(self) -> str:  # round-trips through parse
        toks = []
        if self.every_steps is not None:
            toks.append(f"steps:{self.every_steps}")
        if self.every_s is not None:
            toks.append(f"secs:{self.every_s:g}")
        toks.append(f"drain:{'on' if self.on_drain else 'off'}")
        return ",".join(toks)

    def due(self, step: int, last_step: int, last_time: float,
            now: float) -> Optional[str]:
        """Why a checkpoint is due at ``step``/``now`` given the last
        save's step/time, or ``None`` — the reason string lands in the
        ``persist.checkpoint`` event so a log reader knows which trigger
        fired."""
        if (self.every_steps is not None
                and step - last_step >= self.every_steps):
            return f"steps:{self.every_steps}"
        if self.every_s is not None and now - last_time >= self.every_s:
            return f"secs:{self.every_s:g}"
        return None

    def describe_next(self, step: int, last_step: int, last_time: float,
                      now: float) -> str:
        """Human line for ``dfft-explain``: the next scheduled write
        under this policy from the given save bookkeeping."""
        parts = []
        if self.every_steps is not None:
            nxt = last_step + self.every_steps
            parts.append(f"at step {nxt} "
                         f"({max(0, nxt - step)} step(s) away)")
        if self.every_s is not None:
            left = max(0.0, last_time + self.every_s - now)
            parts.append(f"in {left:.1f} s")
        if not parts:
            return ("on drain only" if self.on_drain
                    else "never (drain:off, no periodic trigger)")
        return (" / ".join(parts)
                + (", plus on drain" if self.on_drain else ""))
