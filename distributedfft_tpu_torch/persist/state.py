"""Solver-state capture and restore of the port — the bridge between the
solver protocol and the checkpoint format (the JAX package's
``persist/state.py``).

A pseudo-spectral solver's durable state is its spectral state (one
tensor for ``NavierStokes2D``, a 3-tuple of component spectra for
``NavierStokes3D``) plus the integration bookkeeping. ``capture`` stores
each field as the plan's PADDED GLOBAL spectral array on the host — on P
ranks gathered from every rank's block (collective: every rank calls it),
on one rank the tensor itself — stamped with the plan fingerprint and the
wisdom provenance: the arrays the JAX package stores. ``restore`` fits a
stored array to the current plan's padded shape (``_fit_padded``) and
cuts this rank's block onto the plan's device (``pad_spectral``), so the
resumed state is the captured state bit for bit, where the plan's
pipelines expect it.

A state's memory layout is part of it here: a plan's spectrum can come
out strided (the last transform's axis innermost), and the same values
in another layout can round differently in the next step. ``capture``
records each field's dimension order (``meta["layouts"]``, innermost
last; a key the JAX package ignores) and ``restore`` lays the block out
in it again, so a resume is bit-exact.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .checkpoint import SimState

StateTree = Union[Any, Tuple[Any, ...]]

_FIELD = "field{}"


def plan_fingerprint(plan: Any) -> Dict[str, Any]:
    """The identity a checkpoint records and restore validates:
    ``resilience.guards.fingerprint`` with the direction label "state"."""
    from ..resilience import guards
    return guards.fingerprint(plan, "state")


def wisdom_provenance(plan: Any) -> Dict[str, Any]:
    """Where the plan's measured choices came from: the wisdom store's
    path and on-disk schema version at capture time (both None without a
    store)."""
    from ..utils import wisdom
    store = wisdom.store_for_config(plan.config)
    if store is None:
        return {"path": None, "version": None}
    return {"path": store.path, "version": store.raw_version()}


def _leaves(state: StateTree) -> Tuple[Any, ...]:
    return tuple(state) if isinstance(state, (tuple, list)) else (state,)


def _spectral_axis(plan: Any) -> Optional[int]:
    """The axis (pencil: the depth-3 stage) a plan's spectral blocks are
    split along; None on one rank."""
    if plan.fft3d:
        return None
    if hasattr(plan, "col_group"):
        return 3
    seq = getattr(plan, "_seq", None)
    return seq.split_axis if seq is not None else plan._out_axis


def _dim_order(t: torch.Tensor) -> list:
    """The dimensions of ``t`` from the outermost in memory to the
    innermost (stride order; ties keep the logical order)."""
    return sorted(range(t.dim()), key=lambda d: (-t.stride(d), d))


def _in_order(t: torch.Tensor, order) -> torch.Tensor:
    """``t`` laid out in memory in dimension order ``order``."""
    if list(order) == list(range(t.dim())):
        return t.contiguous()
    inv = [list(order).index(d) for d in range(t.dim())]
    return t.permute(*order).contiguous().permute(*inv)


def _global_host(plan: Any, leaf: Any) -> np.ndarray:
    """The padded global spectral array of one field on the host."""
    axis = _spectral_axis(plan)
    t = torch.as_tensor(leaf)
    if axis is not None:
        t = plan._gather(t, axis)
    return t.detach().cpu().numpy()


def capture(solver: Any, state: StateTree, step: int, dt: float, *,
            sim_time: float = 0.0, rng: Optional[Dict[str, Any]] = None,
            meta: Optional[Dict[str, Any]] = None) -> SimState:
    """A solver's spectral state as a checkpointable :class:`SimState`
    (host numpy; call between steps)."""
    leaves = _leaves(state)
    plan = solver.plan
    arrays = {_FIELD.format(i): _global_host(plan, leaf)
              for i, leaf in enumerate(leaves)}
    axis = _spectral_axis(plan)
    meta_out = dict(meta or {})
    meta_out.update({
        "solver": type(solver).__name__,
        "n_fields": len(leaves),
        "tuple_state": isinstance(state, (tuple, list)),
        "sharding": (None if axis is None else
                     f"split axis {axis} over {plan.partition.num_ranks} "
                     f"ranks"),
        "layouts": [_dim_order(torch.as_tensor(leaf)) for leaf in leaves],
    })
    return SimState(arrays=arrays, step=int(step), dt=float(dt),
                    sim_time=float(sim_time), rng=rng,
                    plan_fingerprint=plan_fingerprint(plan),
                    wisdom=wisdom_provenance(plan), meta=meta_out)


def _fit_padded(host: np.ndarray, plan: Any) -> np.ndarray:
    """A captured global spectral array adapted to the CURRENT plan's
    padded shape (a different rank count pads split axes to another
    multiple): cropped to the logical extents and zero-padded out (pad
    lanes of a forward output are exact zeros). The same shape returns
    ``host`` untouched, byte for byte."""
    padded = getattr(plan, "output_padded_shape", None)
    if padded is None or tuple(host.shape) == tuple(padded):
        return host
    logical = tuple(getattr(plan, "output_shape", padded))
    if len(logical) != host.ndim or len(padded) != host.ndim:
        return host  # a rank disagreement is for the placement to refuse
    cropped = host[tuple(slice(0, min(h, l))
                         for h, l in zip(host.shape, logical))]
    pad = [(0, p - s) for p, s in zip(padded, cropped.shape)]
    return np.pad(cropped, pad) if any(w for _, w in pad) else cropped


def restore(sim: SimState, solver: Any) -> StateTree:
    """A validated :class:`SimState` as the solver's state on the plan's
    device: this rank's block of each field (the whole field on one
    rank), a tuple for a multi-field solver. Raises ``ValueError`` when a
    field the header counts is absent. A state captured on another rank
    count (``CheckpointStore.load(allow_mesh_change=True)``) is fitted
    through :func:`_fit_padded` first."""
    n = int(sim.meta.get("n_fields", len(sim.arrays)))
    names = [_FIELD.format(i) for i in range(n)]
    missing = [nm for nm in names if nm not in sim.arrays]
    if missing:
        raise ValueError(f"checkpoint meta claims {n} field(s) but "
                         f"sections {missing} are absent")
    plan = solver.plan
    layouts = sim.meta.get("layouts") or [None] * n
    leaves = []
    for nm, order in zip(names, layouts):
        block = plan.pad_spectral(torch.from_numpy(
            np.ascontiguousarray(_fit_padded(sim.arrays[nm], plan))))
        if order is not None and len(order) == block.dim():
            block = _in_order(block, order)
        leaves.append(block)
    if sim.meta.get("tuple_state", n > 1):
        return tuple(leaves)
    return leaves[0]
