"""Op-trace scanning: record one execution of a plan direction and extract
the structural facts the contracts check — the port's counterpart of the
JAX package's ``analysis/hloscan.py``, which compiles a plan and reads
its HLO text. Eager PyTorch has no compiled module to read, so the port
reads the ops one execution dispatches.

``record(fn, *args)`` runs ``fn`` once under a
``torch.utils._python_dispatch.TorchDispatchMode`` that appends every
dispatched op, in order, as an ``Op``: its name (``aten._to_copy.default``,
``c10d.alltoall_base_.default``), the shapes and dtypes of its tensor
arguments and results, and no values. Three details shape what the
trace can say:

* **Kernels are invisible to the mode**: a ctypes launch
  (``ops/hopper_fft._launch``) dispatches nothing, so the recorder also
  appends each launch as an op named ``kernel.<entry point>`` through
  ``hopper_fft.LAUNCH_HOOKS`` (empty, and so free, while no recorder
  runs).
* **Payloads cross as bytes**: every exchange sends a ``uint8`` view
  (``parallel/transpose._bytes``), so a c10d op's ``nbytes`` is the
  payload it moves, and "a native wire is bf16-free" reads "no recorded
  op touches a ``bfloat16`` tensor" (``contains_bf16``).
* **Gloo over CUDA stages through the host**: the census counts the c10d
  ops, not the staging copies around them.

Each op also carries ``where``: the port module and function of the
innermost port frame that dispatched it (``resilience/guards.py:_stats``),
which the lints read (guard ops at ``guards="off"``); and ``async_op``:
whether the c10d call asked for ``async_op=True`` (read from the caller's
frame in ``torch.distributed``), which puts it under ``all_to_all_start``.
Fingerprints hash the names, shapes and dtypes only, without ``where``
and without the ``profiler.*`` ops a ``record_function`` scope dispatches:
the op graph, stable across pure refactors and across scopes on and off.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)
_C10D_FILE = os.path.join("torch", "distributed", "distributed_c10d.py")

# c10d op (the name's middle part) -> census key. Async calls take the
# key's ``_start`` form.
C10D_KEYS: Dict[str, str] = {
    "alltoall_base_": "all_to_all", "alltoall_": "all_to_all",
    "send": "send", "recv_": "recv", "recv_any_source_": "recv",
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "broadcast_": "broadcast", "barrier": "barrier",
}

# Census keys in report order (every census carries each, zeros included).
CENSUS_KEYS: Tuple[str, ...] = (
    "all_to_all", "all_to_all_start", "send", "recv",
    "all_reduce", "all_reduce_start", "all_gather", "all_gather_start",
    "reduce_scatter", "reduce_scatter_start", "broadcast", "barrier")

# Kernel entry points that encode onto / decode off the bf16 wire.
ENCODE_ENTRIES = ("dfft_enc_pack",)
DECODE_ENTRIES = ("dfft_dec_unpack", "dfft_dec_cmatmul", "dfft_dec_fft")

BF16 = "torch.bfloat16"


@dataclasses.dataclass(frozen=True)
class Op:
    """One recorded op: ``name`` (``aten.*`` / ``c10d.*`` / ``profiler.*``
    as dispatched, ``kernel.<entry>`` for a launch), the shapes and dtypes
    of its tensor arguments and results, ``nbytes`` (the payload of an
    exchange op: the all-to-all's input, a send's tensors; 0 otherwise),
    ``async_op``, ``where`` (the innermost port frame,
    ``module.py:function``), ``label`` (a ``profiler.*`` op's scope name;
    a launch's kernel)."""

    name: str
    in_shapes: Tuple[Tuple[int, ...], ...] = ()
    in_dtypes: Tuple[str, ...] = ()
    out_shapes: Tuple[Tuple[int, ...], ...] = ()
    out_dtypes: Tuple[str, ...] = ()
    nbytes: int = 0
    async_op: bool = False
    where: str = ""
    label: str = ""

    @property
    def c10d(self) -> Optional[str]:
        """The census key of a c10d op, else None."""
        if not self.name.startswith("c10d."):
            return None
        base = C10D_KEYS.get(self.name.split(".")[1])
        if base is None:
            return None
        return f"{base}_start" if self.async_op and base in (
            "all_to_all", "all_reduce", "all_gather",
            "reduce_scatter") else base

    @property
    def kernel_entry(self) -> Optional[str]:
        return self.name[len("kernel."):] if self.name.startswith(
            "kernel.") else None

    def dtypes(self) -> Tuple[str, ...]:
        return self.in_dtypes + self.out_dtypes


@dataclasses.dataclass(frozen=True)
class OpTrace:
    """One recorded execution: its ops in dispatch order and the dtypes and
    shapes of the tensors it returned."""

    ops: Tuple[Op, ...]
    out_dtypes: Tuple[str, ...] = ()
    out_shapes: Tuple[Tuple[int, ...], ...] = ()

    def kernels(self) -> Dict[str, int]:
        """Launches per kernel entry point."""
        out: Dict[str, int] = {}
        for op in self.ops:
            e = op.kernel_entry
            if e:
                out[e] = out.get(e, 0) + 1
        return out


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _port_frame(frame) -> str:
    """``relpath:function`` of the innermost frame inside the port (this
    module excluded), or "" when the op came from outside it."""
    while frame is not None:
        fn = frame.f_code.co_filename
        if fn.startswith(_PORT_DIR) and os.path.abspath(fn) != _SELF:
            rel = os.path.relpath(fn, _PORT_DIR).replace(os.sep, "/")
            return f"{rel}:{frame.f_code.co_name}"
        frame = frame.f_back
    return ""


def _async_caller(frame) -> bool:
    """Whether the ``torch.distributed`` call that dispatched a c10d op
    asked for ``async_op=True`` (its frame's local)."""
    while frame is not None:
        if frame.f_code.co_filename.endswith(_C10D_FILE) and \
                "async_op" in frame.f_code.co_varnames:
            return bool(frame.f_locals.get("async_op"))
        frame = frame.f_back
    return False


def _payload_nbytes(name: str, args: Any) -> int:
    """The bytes an exchange op moves from this rank: the all-to-all's
    input (its second tensor argument), a send's tensors; 0 for any other
    op."""
    ts = _tensors(args)
    if ".alltoall_base_." in name:
        ts = ts[1:2]
    elif not name.startswith("c10d.send."):
        return 0
    return sum(t.numel() * t.element_size() for t in ts)


class _Recorder(TorchDispatchMode):
    """The dispatch mode of ``record``: appends one ``Op`` per dispatched
    op (after it ran, so results are known)."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[Op] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        frame = sys._getframe(1)
        ins, outs = _tensors((args, kwargs or {})), _tensors(out)
        c10d = name.startswith("c10d.")
        label = ""
        if name.startswith("profiler."):
            label = next((a for a in args if isinstance(a, str)), "")
        self.ops.append(Op(
            name=name,
            in_shapes=tuple(tuple(t.shape) for t in ins),
            in_dtypes=tuple(str(t.dtype) for t in ins),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            out_dtypes=tuple(str(t.dtype) for t in outs),
            nbytes=_payload_nbytes(name, args),
            async_op=_async_caller(frame) if c10d else False,
            where=_port_frame(frame), label=label))
        return out

    def launch(self, kernel: str, entry: str, args: Sequence[Any]) -> None:
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        self.ops.append(Op(
            name=f"kernel.{entry}",
            in_shapes=tuple(tuple(t.shape) for t in ts),
            in_dtypes=tuple(str(t.dtype) for t in ts),
            where=_port_frame(sys._getframe(2)), label=kernel))


def record(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> OpTrace:
    """Run ``fn(*args, **kwargs)`` once (under ``torch.no_grad``) and return
    the ops it dispatched and the kernels it launched, in order."""
    from ..ops import hopper_fft as hf

    rec = _Recorder()
    hf.LAUNCH_HOOKS.append(rec.launch)
    try:
        with torch.no_grad(), rec:
            out = fn(*args, **kwargs)
    finally:
        hf.LAUNCH_HOOKS.remove(rec.launch)
    outs = _tensors(out)
    return OpTrace(tuple(rec.ops), tuple(str(t.dtype) for t in outs),
                   tuple(tuple(t.shape) for t in outs))


# ---------------------------------------------------------------------------
# plan directions
# ---------------------------------------------------------------------------

def _builder(plan: Any, direction: str, dims: int = 3) -> Callable:
    """The direction's built pipeline across the three families, guard
    included and the resilience envelope left out — what the JAX package
    lowers (duck-typed on the family-specific builder names)."""
    fwd = direction == "forward"
    if direction not in ("forward", "inverse"):
        raise ValueError(f"direction must be 'forward'|'inverse', "
                         f"got {direction!r}")
    if hasattr(plan, "_get_fwd"):                        # batched2d
        return plan._get_fwd() if fwd else plan._get_inv()
    if hasattr(plan, "local_output_shape_for"):          # pencil
        return plan._get(fwd, dims)
    return plan._get_r2c() if fwd else plan._get_c2r()


def plan_input(plan: Any, direction: str, dims: int = 3) -> torch.Tensor:
    """This rank's padded input block of one direction, drawn on the
    plan's device from a seeded generator (the values do not shape the
    trace)."""
    from ..obs.profile import _direction_runner

    _, shape, complex_in = _direction_runner(plan, direction, dims)
    gen = torch.Generator(device=plan.device).manual_seed(0)
    x = torch.randn(tuple(shape), generator=gen, device=plan.device,
                    dtype=plan.real_dtype)
    if complex_in:
        x = torch.complex(x, torch.randn(tuple(shape), generator=gen,
                                         device=plan.device,
                                         dtype=plan.real_dtype))
    return x


def record_plan(plan: Any, direction: str = "forward",
                dims: int = 3) -> OpTrace:
    """The op trace of one execution of a plan direction on this rank's
    seeded block. Collective on a plan over P ranks: every rank calls it."""
    fn = _builder(plan, direction, dims)
    return record(fn, plan_input(plan, direction, dims))


# ---------------------------------------------------------------------------
# census
# ---------------------------------------------------------------------------

def collective_census(trace: OpTrace) -> Dict[str, int]:
    """Instance counts of the collectives (async forms apart), plus
    ``async_total`` and ``convert`` (the dtype-changing ``_to_copy`` ops).
    Mirrored into the obs registry as ``ops.*`` gauges (last census
    wins)."""
    from .. import obs

    out = {k: 0 for k in CENSUS_KEYS}
    for op in trace.ops:
        k = op.c10d
        if k is not None:
            out[k] = out.get(k, 0) + 1
    out["async_total"] = sum(out[k] for k in out if k.endswith("_start"))
    out["convert"] = sum(1 for op in trace.ops if _convert_ends(op))
    for name, v in out.items():
        obs.metrics.gauge(f"ops.{name}", v)
    return out


def _convert_ends(op: Op) -> Optional[Tuple[str, str]]:
    """``(src dtype, dst dtype)`` of a dtype-changing copy, else None."""
    if not op.name.startswith("aten._to_copy") or not op.in_dtypes \
            or not op.out_dtypes:
        return None
    if op.in_dtypes[0] == op.out_dtypes[0]:
        return None
    return op.in_dtypes[0], op.out_dtypes[0]


def contains_bf16(trace: OpTrace) -> bool:
    """Whether any recorded op (a launch included) touches a bfloat16
    tensor — the structural pin behind the native wire's bit identity."""
    return any(BF16 in op.dtypes() for op in trace.ops) or \
        BF16 in trace.out_dtypes


# ---------------------------------------------------------------------------
# exchange payloads
# ---------------------------------------------------------------------------

def exchange_payload_bytes(trace: OpTrace) -> Dict[str, List[int]]:
    """Per-op payload bytes (FROM THIS RANK) of every exchange op, in
    order: ``{"all_to_all": [...], "send": [...]}`` (the async all-to-all
    under ``all_to_all``). Multiply the sum by the mesh size for global
    wire bytes (the convention ``wire_nbytes`` reports)."""
    out: Dict[str, List[int]] = {"all_to_all": [], "send": []}
    for op in trace.ops:
        k = op.c10d
        if k in ("all_to_all", "all_to_all_start"):
            out["all_to_all"].append(op.nbytes)
        elif k == "send":
            out["send"].append(op.nbytes)
    return out


def predicted_payload_bytes(shape: Any, dtype: Any, wire: str,
                            ring_size: int = 0) -> int:
    """GLOBAL wire bytes one exchange of ``shape``/``dtype`` moves under the
    wire encoding (the JAX package's arithmetic): ``wire_nbytes``, with the
    ring discount: a ring of ``ring_size`` ranks never sends the local
    block, so its P-1 steps carry ``(P-1)/P`` of the payload. The
    monolithic all-to-all (``ring_size=0``) carries it whole (its
    local-to-local piece stays in the accounting)."""
    from ..parallel.transpose import wire_nbytes

    nb = wire_nbytes(shape, dtype, wire)
    if ring_size > 1:
        return nb * (ring_size - 1) // ring_size
    return nb


def staged_exchange_total(trace: OpTrace, ranks: int) -> Optional[int]:
    """GLOBAL exchange bytes of one recorded direction: this rank's payload
    sum times the mesh size (every rank moves the same). None when the
    trace holds no exchange op."""
    per = exchange_payload_bytes(trace)
    ops = per["all_to_all"] + per["send"]
    if not ops:
        return None
    return sum(ops) * max(1, int(ranks))


def plan_ranks(plan: Any) -> int:
    """The ranks a plan spans (the JAX package's mesh size)."""
    return int(plan.partition.num_ranks)


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def op_graph_lines(trace: OpTrace) -> List[str]:
    """One line per op of the op graph: name, shapes and dtypes; the
    ``profiler.*`` ops (scopes) are left out."""
    return [f"{op.name} {op.in_shapes} {op.in_dtypes} -> {op.out_shapes} "
            f"{op.out_dtypes} {int(op.async_op)}"
            for op in trace.ops if not op.name.startswith("profiler.")]


def op_graph_fingerprint(trace: OpTrace) -> str:
    """sha256 of ``op_graph_lines`` — the byte-identity currency of the
    zero-overhead pins (obs on/off, fault spec set/unset, enforce/check,
    scopes on/off)."""
    return hashlib.sha256("\n".join(op_graph_lines(trace)).encode()
                          ).hexdigest()


def plan_fingerprint(plan: Any, direction: str = "forward",
                     dims: int = 3) -> str:
    """``op_graph_fingerprint`` of one recorded direction."""
    return op_graph_fingerprint(record_plan(plan, direction, dims))


def scope_labels(trace: OpTrace) -> List[str]:
    """The ``record_function`` names the trace entered (scopes, spans)."""
    return [op.label for op in trace.ops
            if op.name.startswith("profiler.") and op.label]
