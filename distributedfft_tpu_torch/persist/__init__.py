"""``persist/`` — durable simulation state of the port (the JAX
package's ``persist/``; its files read in both packages).

Crash-consistent checkpoint/restore for the spectral solvers:

* :mod:`~.checkpoint` — the versioned, self-describing, per-section
  CRC32C-checksummed file format; atomic writes with the wisdom-store
  discipline (temp + fsync + ``os.replace`` under the advisory flock);
  the two-generation :class:`CheckpointStore` rotation whose ``load``
  falls back exactly one generation on corruption and refuses a
  fingerprint-mismatched plan with a structured
  :class:`CheckpointMismatch`;
* :mod:`~.policy` — :class:`CheckpointPolicy` (every-N-steps /
  every-T-seconds / on-drain) with the strict ``steps:N,secs:T,drain:*``
  spec grammar;
* :mod:`~.state` — solver-protocol capture/restore: the padded global
  spectral arrays on the host (gathered from every rank's block on P
  ranks) with the plan fingerprint and wisdom provenance, restored as
  this rank's block on the plan's device for a bit-exact resume.

Faults: ``$DFFT_FAULT_SPEC=checkpoint:torn|corrupt|stale``
(``resilience/inject.py``) damages a landed file; the ``persist.*``
metrics and the ``checkpoint_restore_failure`` flight-recorder trigger
record what the store skipped.
"""

from __future__ import annotations

from .checkpoint import (CHECKPOINT_VERSION, CheckpointCorrupt,
                         CheckpointError, CheckpointMismatch,
                         CheckpointMissing, CheckpointStore,
                         CheckpointUnusable, GENERATION_SLOTS,
                         MESH_CHANGE_FIELDS, SimState, crc32c,
                         fingerprint_mismatch, read_checkpoint,
                         write_checkpoint)
from .policy import CheckpointPolicy
from .state import capture, plan_fingerprint, restore, wisdom_provenance

ENV_DIR = "DFFT_CKPT_DIR"
ENV_POLICY = "DFFT_CKPT_POLICY"


def resolve_env(dir_arg: "str | None",
                policy_arg: "str | None") -> "tuple[str | None, str | None]":
    """The ONE flag-else-env resolution every CLI shares: checkpoint
    directory (``$DFFT_CKPT_DIR``) and policy spec
    (``$DFFT_CKPT_POLICY``), the policy validated LOUDLY (``ValueError``
    — callers turn it into their usage error) before any work starts.
    Returns ``(abs_dir_or_None, policy_str_or_None)``."""
    import os as _os
    d = dir_arg or _os.environ.get(ENV_DIR) or None
    p = policy_arg or _os.environ.get(ENV_POLICY) or None
    if p:
        CheckpointPolicy.parse(p)
    return (_os.path.abspath(_os.path.expanduser(d)) if d else None, p)

__all__ = [
    "CHECKPOINT_VERSION", "GENERATION_SLOTS", "ENV_DIR", "ENV_POLICY",
    "CheckpointError", "CheckpointCorrupt", "CheckpointMissing",
    "CheckpointMismatch", "CheckpointUnusable", "CheckpointPolicy",
    "CheckpointStore", "MESH_CHANGE_FIELDS", "SimState", "capture", "crc32c",
    "fingerprint_mismatch", "plan_fingerprint", "read_checkpoint",
    "resolve_env", "restore", "wisdom_provenance",
]
