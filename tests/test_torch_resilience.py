"""The port's resilience layer (``distributedfft_tpu_torch/resilience/``)
against the JAX package's, on the same numpy inputs.

Host-side pieces run in this process: the fault-spec grammar and its
``str()`` round trips for every case of ``tests/test_resilience.py``,
``parseval_tolerance`` and ``_halved_weights`` (exact), ``taint_wire``
(bit for bit JAX's on complex64, complex128, float32 and bf16 planes),
``next_rung`` / ``ladder_preview`` (the same rungs and labels), the host
hooks of the injector, the coordinator backoff, the ambient-deadline bound
of the ladder (``tests/test_serve.py:400``) and the single-rank selftest.

One 4-rank gloo world (a module fixture) runs every distributed case; each
case stays its own test. The ranks import this module to find
``_rank_main``, so it imports neither JAX nor the JAX package at its top:
the references are computed in the parent, on a 4-device mesh (2 x 2 for
the pencil).

* The guarded slab (four renderings), pencil (2 x 2) and batched
  (``shard="x"``) plans at 16^3 and at the uneven 12 x 20 x 14 give the
  JAX plan's verdict under clean, NaN, bitflip and scale faults, every
  rank raising ``GuardViolation`` under ``enforce`` with the same check and
  fingerprint; clean runs in ``check`` mode are bit for bit the unguarded
  plan's; the guard energies are within 1e-6 relative of JAX's
  ``_energy`` on the same arrays.
* The ladder (``tests/test_resilience.py``): one rung per failure, the
  default rendering's errors propagate (and it posts no agreement
  collective), ``$DFFT_FALLBACK=off``, a ``GuardViolation`` is never
  retried; a ``KernelError`` is never retried either; a failure on one
  rank only demotes every rank; a check-mode wire drift demotes both the
  wire and the ranks to native.
* The selftest (PASS, FAIL under ``wire:scale``) and the ``--selftest``
  gate of the slab executable, on every rank.
"""

import dataclasses
import os
import pickle
import sys
import time
import traceback

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import obs
from distributedfft_tpu_torch.ops import _build
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.resilience import (GuardViolation, fallback,
                                                 guards, inject)

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
SEED = 700
FAULTS = (None, "wire:nan", "wire:bitflip", "wire:scale:0.5")
SHAPES = {"16": (16, 16, 16), "uneven": (12, 20, 14),
          "padded": (10, 18, 13)}

# Guarded plans: id -> (kind, sequence, Config fields, extra plan kwargs).
RENDERINGS = {
    "slab-a2a": ("slab", "ZY_Then_X", dict(comm_method="All2All"), {}),
    "slab-opt1": ("slab", "ZY_Then_X", dict(comm_method="All2All", opt=1),
                  {}),
    "slab-ring": ("slab", "Z_Then_YX", dict(send_method="Ring"), {}),
    "slab-p2p-wire16": ("slab", "ZY_Then_X",
                        dict(comm_method="Peer2Peer", wire_dtype="bf16"), {}),
    "pencil": ("pencil", None, dict(comm_method="Peer2Peer"), {}),
    "batched-x": ("batched", None, dict(comm_method="All2All"),
                  dict(shard="x")),
}

# The padded shape (every family pads a split axis there, the last rank
# holding pad lanes) runs clean and under NaN.
VERDICTS = {f"{rid}-{sid}-{(f or 'clean').replace(':', '_')}":
            (rid, SHAPES[sid], f)
            for rid in RENDERINGS for sid in SHAPES
            for f in (FAULTS if sid != "padded" else FAULTS[:2])}
# The inverse guards: finiteness for C2R, Parseval for the C2C inverse.
INVERSE = {"inv-c2r-nan": ("slab-a2a", "r2c", "wire:nan"),
           "inv-c2r-scale": ("slab-a2a", "r2c", "wire:scale:0.5"),
           "inv-c2c-clean": ("slab-a2a", "c2c", None),
           "inv-c2c-scale": ("slab-a2a", "c2c", "wire:scale:0.5")}


def _config(pkg, fields, **more):
    kw = dict(fields, **more)
    for k, enum in (("send_method", pkg.SendMethod),
                    ("comm_method", pkg.CommMethod)):
        if k in kw:
            kw[k] = enum(kw[k])
    return pkg.Config(**kw)


def _plan(pkg, rid, shape, transform="r2c", mesh=None, **cfg_more):
    """The plan of ``rid`` in ``pkg`` (the port on the CPU, or JAX on
    ``mesh``)."""
    kind, seq, fields, extra = RENDERINGS[rid]
    cfg = _config(pkg, fields, **cfg_more)
    where = {"device": "cpu"} if pkg is tdfft else {}
    g = pkg.GlobalSize(*shape)
    if kind == "slab":
        if mesh is not None:
            where["mesh"] = mesh
        return pkg.SlabFFTPlan(g, pkg.SlabPartition(P), cfg, sequence=seq,
                               transform=transform, **where)
    if kind == "pencil":
        return pkg.PencilFFTPlan(g, pkg.PencilPartition(2, 2), cfg,
                                 transform=transform, **where)
    if mesh is not None:
        where["mesh"] = mesh
    return pkg.Batched2DFFTPlan(*shape, pkg.SlabPartition(P), cfg,
                                transform=transform, **extra, **where)


def _input(shape, transform="r2c", seed=SEED):
    rng = np.random.default_rng(seed)
    x = rng.random(shape)
    if transform == "c2c":
        x = x + 1j * rng.random(shape)
        return x.astype(np.complex64)
    return x.astype(np.float32)


def _spectrum(plan_shape, seed=SEED + 1):
    rng = np.random.default_rng(seed)
    return (rng.random(plan_shape) + 1j * rng.random(plan_shape)).astype(
        np.complex64)


def _fwd(plan):
    if type(plan).__name__ == "Batched2DFFTPlan":
        return plan.exec_forward
    return plan.exec_c2c if plan.transform == "c2c" else plan.exec_r2c


def _inv(plan):
    if type(plan).__name__ == "Batched2DFFTPlan":
        return plan.exec_inverse
    return plan.exec_c2c_inv if plan.transform == "c2c" else plan.exec_c2r


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """Clean metrics and no fault/guard/fallback env around every test."""
    for var in (inject.ENV_VAR, "DFFT_GUARDS", "DFFT_FALLBACK",
                "DFFT_COORD_RETRIES", "DFFT_COORD_BACKOFF_S"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    yield
    obs.reset()


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------


def _counters():
    return dict(obs.metrics.snapshot()["counters"])


def _set_fault(spec):
    if spec is None:
        os.environ.pop(inject.ENV_VAR, None)
    else:
        os.environ[inject.ENV_VAR] = spec


def _violation(fn):
    """Run ``fn``: ``None`` when it returns, else the violation's fields."""
    try:
        fn()
    except GuardViolation as e:
        return {"check": e.check, "value": e.value,
                "tolerance": e.tolerance, "fingerprint": e.fingerprint}
    return None


def _run_verdict(cid):
    rid, shape, fault = VERDICTS[cid]
    x = _input(shape)
    out = {}
    if fault is None:
        plain = _plan(tdfft, rid, shape)
        checked = _plan(tdfft, rid, shape, guards="check")
        want = _fwd(plain)(plain.pad_input(x))
        got = _fwd(checked)(checked.pad_input(x))
        out["bit_equal"] = bool(torch.equal(want, got))
        region = guards.region(checked, "forward")
        gspec = checked._guard_spec("forward")
        out["energies"] = guards.parseval_sums(
            gspec, checked.pad_input(x), got, region).tolist()
        out["violations"] = _counters().get("guard.parseval_violations", 0)
    _set_fault(fault)
    try:
        plan = _plan(tdfft, rid, shape, guards="enforce")
        obs.reset()
        out["violation"] = _violation(lambda: _fwd(plan)(plan.pad_input(x)))
        out["counters"] = _counters()
    finally:
        _set_fault(None)
    return out


def _run_inverse(cid):
    rid, tr, fault = INVERSE[cid]
    shape = SHAPES["16"]
    _set_fault(fault)
    try:
        plan = _plan(tdfft, rid, shape, transform=tr, guards="enforce")
        c = plan.pad_spectral(_spectrum(plan.output_shape))
        return {"violation": _violation(lambda: _inv(plan)(c))}
    finally:
        _set_fault(None)


def _count_collectives():
    """Wrap torch.distributed.all_reduce to count its calls; returns the
    call list and the function that restores it."""
    import torch.distributed as dist
    calls = []
    real = dist.all_reduce

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    dist.all_reduce = counted
    return calls, lambda: setattr(dist, "all_reduce", real)


def _ladder_one_rung_per_failure():
    from distributedfft_tpu_torch.models import slab as slab_mod
    from distributedfft_tpu_torch.parallel import transpose as tr
    real_ring, real_a2a = slab_mod.ring_transpose, tr.all_to_all_transpose

    def ring_boom(*a, **k):
        raise RuntimeError("simulated ring failure")

    def opt1_boom(x, group, split, concat, *, realigned=False, wire="native"):
        if realigned:
            raise RuntimeError("simulated realigned-pack failure")
        return real_a2a(x, group, split, concat, realigned=realigned,
                        wire=wire)

    slab_mod.ring_transpose, tr.all_to_all_transpose = ring_boom, opt1_boom
    try:
        plan = _plan(tdfft, "slab-ring", SHAPES["16"])
        x = plan.pad_input(_input(SHAPES["16"]))
        got = plan.exec_r2c(x)
    finally:
        slab_mod.ring_transpose, tr.all_to_all_transpose = real_ring, real_a2a
    want = tdfft.SlabFFTPlan(plan.global_size, plan.partition,
                             _config(tdfft, dict(comm_method="All2All")),
                             device="cpu", sequence="Z_Then_YX")
    return {"counters": _counters(), "send": plan.config.send_method.value,
            "opt": plan.config.opt,
            "bit_equal": bool(torch.equal(got, want.exec_r2c(x)))}


def _default_errors_propagate():
    from distributedfft_tpu_torch.parallel import transpose as tr
    real = tr.all_to_all_transpose

    def boom(*a, **k):
        raise RuntimeError("genuine failure")

    plan = _plan(tdfft, "slab-a2a", SHAPES["16"])
    x = plan.pad_input(_input(SHAPES["16"]))
    calls, restore = _count_collectives()
    tr.all_to_all_transpose = boom
    try:
        try:
            plan.exec_r2c(x)
            err = None
        except RuntimeError as e:
            err = str(e)
    finally:
        tr.all_to_all_transpose = real
        restore()
    # The healthy default plan posts no collective but its exchange.
    calls2, restore = _count_collectives()
    try:
        plan.exec_r2c(x)
    finally:
        restore()
    return {"raised": err, "counters": _counters(),
            "agreement_calls": len(calls), "healthy_calls": len(calls2)}


def _ladder_disabled_by_env():
    from distributedfft_tpu_torch.models import slab as slab_mod
    real = slab_mod.ring_transpose

    def boom(*a, **k):
        raise RuntimeError("ring failure")

    os.environ["DFFT_FALLBACK"] = "off"
    slab_mod.ring_transpose = boom
    try:
        plan = _plan(tdfft, "slab-ring", SHAPES["16"])
        try:
            plan.exec_r2c(plan.pad_input(_input(SHAPES["16"])))
            err = None
        except RuntimeError as e:
            err = str(e)
    finally:
        slab_mod.ring_transpose = real
        os.environ.pop("DFFT_FALLBACK")
    return {"raised": err, "counters": _counters()}


def _guard_violation_not_retried():
    _set_fault("wire:nan")
    try:
        plan = _plan(tdfft, "slab-ring", SHAPES["16"], guards="enforce")
        v = _violation(lambda: plan.exec_r2c(
            plan.pad_input(_input(SHAPES["16"]))))
    finally:
        _set_fault(None)
    return {"violation": v, "counters": _counters(),
            "send": plan.config.send_method.value}


def _kernel_error_not_retried():
    """A RING plan on the fused wire whose kernel-9 launcher raises
    ``KernelError``: it propagates, no rung is walked."""
    from distributedfft_tpu_torch.ops import hopper_fft as hf
    real = hf.wire_encode_fused

    def launch_fails(*a, **k):
        raise _build.KernelError("dfft_enc_pack: CUDA error 700 (an illegal "
                                 "memory access was encountered)")

    hf.wire_encode_fused = launch_fails
    try:
        plan = _plan(tdfft, "slab-ring", SHAPES["16"], wire_dtype="bf16",
                     fused_wire=True, fft_backend="pallas")
        try:
            plan.exec_r2c(plan.pad_input(_input(SHAPES["16"])))
            err = None
        except _build.KernelError as e:
            err = str(e)
    finally:
        hf.wire_encode_fused = real
    return {"raised": err, "counters": _counters(),
            "send": plan.config.send_method.value}


def _one_rank_fails():
    """Rank 1's ring attempt fails after the exchange; every rank demotes
    one rung together and ends on the all-to-all's bits."""
    rank = torch.distributed.get_rank()
    plan = _plan(tdfft, "slab-ring", SHAPES["16"])
    build = plan._build_r2c

    def failing_on_rank1():
        pipe = build()
        if plan.config.send_method is not tdfft.SendMethod.RING:
            return pipe

        def run(x):
            y = pipe(x)
            if rank == 1:
                raise RuntimeError("rank 1's post-exchange stage failed")
            return y

        return run

    plan._build_r2c = failing_on_rank1
    x = plan.pad_input(_input(SHAPES["16"]))
    got = plan.exec_r2c(x)
    want = tdfft.SlabFFTPlan(plan.global_size, plan.partition,
                             _config(tdfft, dict(comm_method="All2All")),
                             device="cpu", sequence="Z_Then_YX")
    return {"counters": _counters(), "send": plan.config.send_method.value,
            "bit_equal": bool(torch.equal(got, want.exec_r2c(x)))}


def _wire_drift_demotes():
    plan = _plan(tdfft, "slab-a2a", SHAPES["16"], wire_dtype="bf16",
                 wire_error_budget=1e-9, guards="check")
    x = plan.pad_input(_input(SHAPES["16"]))
    plan.exec_r2c(x)
    counters = _counters()
    native = _plan(tdfft, "slab-a2a", SHAPES["16"])
    return {"counters": counters, "wire": plan.config.wire_dtype,
            "bit_equal": bool(torch.equal(plan.exec_r2c(x),
                                          native.exec_r2c(x)))}


def _selftest(fault):
    from distributedfft_tpu_torch.resilience.selftest import run_selftest
    _set_fault(fault)
    try:
        plan = _plan(tdfft, "slab-a2a", SHAPES["16"])
        r = run_selftest(plan)
    finally:
        _set_fault(None)
    return {"ok": r["ok"], "parseval": r["parseval"],
            "roundtrip": r["roundtrip"], "reference": r["reference"],
            "counters": _counters()}


def _cli_gate(fault):
    import tempfile
    from distributedfft_tpu_torch.cli import slab as cli_slab
    argv = ["-nx", "16", "-ny", "16", "-nz", "16", "-t", "3",
            "--selftest", "-comm", "All2All", "--emulate-devices", str(P),
            "-b", tempfile.mkdtemp(prefix="dfft_cli_gate_")]
    _set_fault(fault)
    try:
        return {"rc": cli_slab.main(argv)}
    finally:
        _set_fault(None)


def _obs_log(outdir):
    """Check mode, then enforce, under ``wire:nan`` with the event log on:
    the log carries the injection and the violation; enforce dumps the
    flight recorder."""
    d = os.path.join(outdir, "obs")
    os.environ[flightrec_env()] = d
    obs.flightrec.clear()       # the earlier cases' cooldown windows
    obs.enable(d)
    _set_fault("wire:nan")
    try:
        plan = _plan(tdfft, "slab-a2a", SHAPES["16"], guards="check")
        x = plan.pad_input(_input(SHAPES["16"]))
        plan.exec_r2c(x)
        plan = _plan(tdfft, "slab-a2a", SHAPES["16"], guards="enforce")
        violation = _violation(lambda: plan.exec_r2c(x))
    finally:
        _set_fault(None)
        obs.reset_enablement()
        os.environ.pop(flightrec_env())
    return {"log": obs_event_log(d), "dump": obs.flightrec.last_dump(),
            "violation": violation}


def flightrec_env():
    return obs.flightrec.ENV_DIR


def obs_event_log(d):
    return os.path.join(d, f"events-{os.getpid()}.jsonl")


RANK_CASES = {
    "ladder": _ladder_one_rung_per_failure,
    "default_propagates": _default_errors_propagate,
    "ladder_off": _ladder_disabled_by_env,
    "guard_not_retried": _guard_violation_not_retried,
    "kernel_error": _kernel_error_not_retried,
    "one_rank_fails": _one_rank_fails,
    "wire_drift": _wire_drift_demotes,
    "selftest_pass": lambda: _selftest(None),
    "selftest_fail": lambda: _selftest("wire:scale:0.5"),
    "cli_pass": lambda: _cli_gate(None),
    "cli_fail": lambda: _cli_gate("wire:nan"),
}


def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=120)
    results = {}
    cases = [(cid, _run_verdict) for cid in VERDICTS]
    cases += [(cid, _run_inverse) for cid in INVERSE]
    cases += [(cid, None) for cid in RANK_CASES]
    cases += [("obs_log", lambda _: _obs_log(outdir))]
    for cid, fn in cases:
        obs.reset()
        try:
            results[cid] = fn(cid) if fn is not None else RANK_CASES[cid]()
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[cid] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown()


# ---------------------------------------------------------------------------
# The parent: JAX references and comparisons
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("resilience")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
        nprocs=P, start_method="spawn")
    out = []
    for r in range(P):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _result(world, rank, cid):
    res = world[rank][cid]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank} failed case {cid}:\n{res['error']}")
    return res


def _jax_mesh(rid, devices):
    from distributedfft_tpu.parallel.mesh import make_slab_mesh
    return None if RENDERINGS[rid][0] == "pencil" else make_slab_mesh(
        P, devices)


def _jax_violation(fn):
    from distributedfft_tpu.resilience import GuardViolation as JViolation
    try:
        fn()
    except JViolation as e:
        return e
    return None


def test_ranks_import_no_jax(world):
    for r in range(P):
        assert world[r]["modules"] == []


@pytest.mark.parametrize("cid", list(VERDICTS))
def test_guard_verdicts_match_jax(world, devices, monkeypatch, cid):
    """Every rank reaches the JAX plan's verdict, with the same check and
    fingerprint; clean runs are bit for bit the unguarded plan's."""
    import distributedfft_tpu as jdfft
    rid, shape, fault = VERDICTS[cid]
    if fault is not None:
        monkeypatch.setenv("DFFT_FAULT_SPEC", fault)
    jplan = _plan(jdfft, rid, shape, mesh=_jax_mesh(rid, devices),
                  guards="enforce")
    jv = _jax_violation(lambda: _fwd(jplan)(jplan.pad_input(_input(shape))))
    res = [_result(world, r, cid) for r in range(P)]
    if jv is None:
        assert all(r["violation"] is None for r in res), res
    else:
        for r in res:
            v = r["violation"]
            assert v is not None, (cid, "the port did not raise")
            assert v["check"] == jv.check
            assert v["fingerprint"] == jv.fingerprint
            assert v["fingerprint"] == res[0]["violation"]["fingerprint"]
            assert v["value"] == res[0]["violation"]["value"] or (
                np.isnan(v["value"]) and np.isnan(res[0]["violation"]["value"]))
    if fault is None:
        assert all(r["bit_equal"] for r in res)
        assert all(r["violations"] == 0 for r in res)
    else:
        assert all(r["counters"].get("inject.wire_faults", 0) >= 1
                   for r in res)


@pytest.mark.parametrize("cid", [c for c in VERDICTS if c.endswith("clean")])
def test_guard_energies_match_jax(world, devices, cid):
    """The energies the guard reduces (summed over the ranks) within 1e-6
    relative of JAX's ``_energy`` on the JAX plan's arrays. JAX's reduction
    runs in the arrays' float32, whose own rounding reaches 1.3e-6 of the
    true energy at these sizes, so its ``_energy`` runs on the arrays
    widened to float64 (the port's partial sums are float64)."""
    import distributedfft_tpu as jdfft
    import jax.numpy as jnp
    from distributedfft_tpu.resilience import guards as jguards
    rid, shape, _ = VERDICTS[cid]
    jplan = _plan(jdfft, rid, shape, mesh=_jax_mesh(rid, devices))
    jx = jplan.pad_input(_input(shape))
    jy = _fwd(jplan)(jx)
    spec = jplan._guard_spec("forward", 2 if rid == "batched-x" else 3)
    jx = jnp.asarray(np.asarray(jx), jnp.float64)
    jy = jnp.asarray(np.asarray(jy), jnp.complex128)
    want = [float(jguards._energy(jguards._slice_logical(jx,
                                                         spec.in_logical),
                                  None, 0)),
            float(jguards._energy(jguards._slice_logical(jy,
                                                         spec.out_logical),
                                  spec.halved_axis, spec.halved_n))]
    for r in range(P):
        got = _result(world, r, cid)["energies"]
        assert got == _result(world, 0, cid)["energies"]
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("cid", list(INVERSE))
def test_inverse_guards_match_jax(world, devices, monkeypatch, cid):
    """C2R inverses check finiteness (a NaN is caught, a scale is not);
    the C2C inverse keeps Parseval."""
    import distributedfft_tpu as jdfft
    rid, tr, fault = INVERSE[cid]
    if fault is not None:
        monkeypatch.setenv("DFFT_FAULT_SPEC", fault)
    jplan = _plan(jdfft, rid, SHAPES["16"], transform=tr,
                  mesh=_jax_mesh(rid, devices), guards="enforce")
    c = jplan.pad_spectral(_spectrum(jplan.output_shape))
    jv = _jax_violation(lambda: _inv(jplan)(c))
    for r in range(P):
        v = _result(world, r, cid)["violation"]
        assert (v is None) == (jv is None), (r, v, jv)
        if jv is not None:
            assert v["check"] == jv.check
            assert v["fingerprint"] == jv.fingerprint


def test_enforce_under_nan_raises_as_jax(world):
    """The old silent case: ``Config(guards="enforce")`` under ``wire:nan``
    ran unguarded in the port and returned a wrong spectrum; now every rank
    raises, as the JAX plan does (its verdict: the case above)."""
    for r in range(P):
        v = _result(world, r, "slab-a2a-16-wire_nan")["violation"]
        assert v is not None and v["check"] in ("parseval", "finite")
        assert v["fingerprint"]["shape"] == [16, 16, 16]
        assert v["fingerprint"]["direction"] == "forward"


# -- the ladder ---------------------------------------------------------------


def test_ladder_demotes_one_rung_per_failure(world):
    """ring fails -> opt1; opt1 fails -> default; each failure walked
    exactly one rung on every rank; the result is the all-to-all's."""
    for r in range(P):
        res = _result(world, r, "ladder")
        c = res["counters"]
        assert c.get("fallback.demotions") == 2
        assert c.get("fallback.send_demotions") == 1
        assert c.get("fallback.opt_demotions") == 1
        assert (res["send"], res["opt"]) == ("Sync", 0)
        assert res["bit_equal"]


def test_default_rendering_errors_propagate(world):
    """A default-config plan has zero rungs: its errors are never retried
    or masked, and it posts no agreement collective."""
    for r in range(P):
        res = _result(world, r, "default_propagates")
        assert res["raised"] == "genuine failure"
        assert res["counters"].get("fallback.demotions", 0) == 0
        assert res["agreement_calls"] == 0
        assert res["healthy_calls"] == 0


def test_ladder_disabled_by_env(world):
    for r in range(P):
        res = _result(world, r, "ladder_off")
        assert res["raised"] == "ring failure"
        assert res["counters"].get("fallback.demotions", 0) == 0


def test_guard_violation_not_retried_by_ladder(world):
    for r in range(P):
        res = _result(world, r, "guard_not_retried")
        assert res["violation"] is not None
        assert res["counters"].get("fallback.demotions", 0) == 0
        assert res["send"] == "Ring"


def test_kernel_error_not_retried_by_ladder(world):
    """A launch error of a hand-written kernel propagates on a plan with
    rungs left: the ladder never steps around a failing kernel."""
    for r in range(P):
        res = _result(world, r, "kernel_error")
        assert res["raised"] and "CUDA error 700" in res["raised"]
        assert res["counters"].get("fallback.demotions", 0) == 0
        assert res["send"] == "Ring"


def test_one_rank_failure_demotes_every_rank(world):
    for r in range(P):
        res = _result(world, r, "one_rank_fails")
        assert res["counters"].get("fallback.demotions") == 1
        assert res["counters"].get("fallback.send_demotions") == 1
        assert res["send"] == "Sync"
        assert res["bit_equal"]


def test_check_mode_wire_drift_demotes_to_native(world):
    for r in range(P):
        res = _result(world, r, "wire_drift")
        c = res["counters"]
        assert c.get("guard.wire_drift_violations") == 1
        assert c.get("fallback.wire_demotions") == 1
        assert res["wire"] == "native"
        assert res["bit_equal"]


# -- selftest and the executable's gate -------------------------------------


def test_selftest_matches_jax(world, devices, monkeypatch):
    """PASS on a healthy plan, FAIL under ``wire:scale:0.5``, on every rank
    as in the JAX package; no host reference in a world of 4 ranks."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.resilience.selftest import run_selftest as jrun
    for cid, fault in (("selftest_pass", None),
                       ("selftest_fail", "wire:scale:0.5")):
        if fault:
            monkeypatch.setenv("DFFT_FAULT_SPEC", fault)
        jplan = _plan(jdfft, "slab-a2a", SHAPES["16"],
                      mesh=_jax_mesh("slab-a2a", devices))
        want = jrun(jplan)
        for r in range(P):
            res = _result(world, r, cid)
            assert res["ok"] == want["ok"], (cid, r)
            assert res["reference"] is None
            assert res["counters"].get("selftest.runs") == 1
            assert res["counters"].get("selftest.failures", 0) == \
                (0 if want["ok"] else 1)
            if want["ok"]:
                assert res["roundtrip"] <= 1e-6
                assert abs(res["parseval"] - want["parseval"]) <= 1e-5


def test_event_log_carries_injection_and_guard_events(world):
    """Each rank's event log and flight-recorder dump pass the port's and
    the JAX package's validators; the log names the injected fault and
    the violation, the dump the violation's evidence."""
    import json
    from distributedfft_tpu.obs import flightrec as jflightrec
    from distributedfft_tpu.obs import tracing as jtracing
    for r in range(P):
        res = _result(world, r, "obs_log")
        n = obs.validate_events_file(res["log"])
        assert n > 0 and jtracing.validate_events_file(res["log"]) == n
        with open(res["log"]) as f:
            names = {json.loads(ln)["name"] for ln in f if ln.strip()}
        assert {"inject.wire_fault", "guard.violation", "plan.build",
                "plan.created", "exchange.all_to_all"} <= names
        assert res["violation"] is not None
        dump = res["dump"]
        assert dump["trigger"] == "guard_violation"
        m = obs.flightrec.validate_dump_file(dump["path"])
        assert jflightrec.validate_dump_file(dump["path"]) == m
        assert m == dump["records"] > 0


def test_cli_selftest_gate(world):
    for r in range(P):
        assert _result(world, r, "cli_pass")["rc"] == 0
        assert _result(world, r, "cli_fail")["rc"] == 1


def test_selftest_single_rank_with_reference(capsys, monkeypatch):
    """One rank: the host reference sub-check runs; FAIL under a fault is
    impossible there (no exchange), so the FAIL line is driven by a
    corrupted plan output."""
    from distributedfft_tpu_torch.resilience.selftest import run_selftest
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 12, 10),
                             tdfft.SlabPartition(1), device="cpu")
    r = run_selftest(plan)
    assert r["ok"] and r["reference"] is not None and r["reference"] < 1e-5
    assert "selftest: PASS" in capsys.readouterr().out
    real = plan._build_r2c
    plan._r2c = None
    monkeypatch.setattr(plan, "_build_r2c", lambda: (lambda x: real()(x) * 2))
    r = run_selftest(plan)
    assert not r["ok"]
    assert "selftest: FAIL" in capsys.readouterr().out
    assert obs.metrics.counter_value("selftest.failures") == 1


# ---------------------------------------------------------------------------
# Host-side pieces against JAX (no world)
# ---------------------------------------------------------------------------

GOOD_SPECS = ["wire:scale:0.25@seed=7", "coordinator:down:2",
              "wisdom:stale-lock", "server:slow:25", "server:slow",
              "wire:nan", "wire:bitflip", "wire:scale", "worker:crash:3@seed=1",
              "worker:crash", "worker:hang:500", "worker:devloss:4@seed=0",
              "worker:devloss", "checkpoint:torn:16", "checkpoint:corrupt@seed=9",
              "checkpoint:stale", "autotune:hang:30", "WIRE:NaN"]
BAD_SPECS = ["wire", "wire:frobnicate", "bogus:nan", "wire:nan@x=1",
             "wire:nan:oops:extra", "server:fast", "server", "worker",
             "worker:oops", "worker:crash:2:3", "worker:devloss:2:3"]
MULTI_SPECS = ["wire:bitflip,server:slow:40@seed=3",
               "wire:bitflip,worker:crash:2@seed=1",
               "wire:nan,worker:devloss:2@seed=1", "wire:nan,server:slow:5"]
BAD_MULTI = ["wire:nan,,", ",server:slow", "wire:nan,bogus:x",
             "wire:nan,wire:bitflip", "worker:crash,worker:hang"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_fault_spec_grammar_matches_jax(spec):
    from distributedfft_tpu.resilience import inject as jinject
    got, want = inject.parse_fault_spec(spec), jinject.parse_fault_spec(spec)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert str(got) == str(want)
    assert inject.parse_fault_spec(str(got)) == got


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_spec_grammar_rejects_as_jax(spec):
    from distributedfft_tpu.resilience import inject as jinject
    with pytest.raises(ValueError):
        jinject.parse_fault_spec(spec)
    with pytest.raises(ValueError):
        inject.parse_fault_spec(spec)


@pytest.mark.parametrize("spec", MULTI_SPECS + BAD_MULTI)
def test_multi_fault_spec_grammar_matches_jax(spec, monkeypatch):
    from distributedfft_tpu.resilience import inject as jinject
    try:
        want = [dataclasses.astuple(s) for s in
                jinject.parse_fault_specs(spec)]
    except ValueError:
        with pytest.raises(ValueError):
            inject.parse_fault_specs(spec)
        return
    got = inject.parse_fault_specs(spec)
    assert [dataclasses.astuple(s) for s in got] == want
    monkeypatch.setenv(inject.ENV_VAR, spec)
    assert inject.active() == got[0]
    assert [s.kind for s in inject.active_specs()] == [w[0] for w in want]


def test_worker_fault_hooks_gate_on_victim_and_generation(monkeypatch):
    """``tests/test_resilience.py``'s case on the port's hooks."""
    assert inject.maybe_crash_worker(0, 0) is None
    assert inject.maybe_hang_worker(0, 0) is None
    monkeypatch.setenv(inject.ENV_VAR, "worker:hang:50@seed=1")
    t0 = time.monotonic()
    inject.maybe_hang_worker(0, 0)
    inject.maybe_hang_worker(1, 1)
    assert time.monotonic() - t0 < 0.04
    inject.maybe_hang_worker(1, 0)
    assert time.monotonic() - t0 >= 0.05
    assert obs.metrics.counter_value("inject.worker_hangs") == 1
    monkeypatch.setenv(inject.ENV_VAR, "worker:crash:99@seed=1")
    inject._WORKER_REQS[0] = 0
    inject.maybe_crash_worker(0, 0)
    inject.maybe_crash_worker(1, 1)
    assert inject._WORKER_REQS[0] == 0
    inject.maybe_crash_worker(1, 0)
    assert inject._WORKER_REQS[0] == 1
    inject._WORKER_REQS[0] = 0


def test_worker_devloss_gating(monkeypatch):
    assert inject.maybe_devloss_worker(0, 0) is None
    assert inject.devloss_cut(0, 1) == 0
    monkeypatch.setenv(inject.ENV_VAR, "worker:devloss:4@seed=1")
    monkeypatch.setenv("DFFT_DEVLOSS_AFTER", "99")
    inject._WORKER_REQS[0] = 0
    inject.maybe_devloss_worker(0, 0)
    inject.maybe_devloss_worker(1, 1)
    assert inject._WORKER_REQS[0] == 0
    inject.maybe_devloss_worker(1, 0)
    assert inject._WORKER_REQS[0] == 1
    inject._WORKER_REQS[0] = 0
    assert [inject.devloss_cut(*a) for a in ((1, 1), (1, 2), (1, 0), (0, 1))
            ] == [4, 4, 0, 0]
    monkeypatch.setenv(inject.ENV_VAR, "worker:devloss@seed=1")
    assert inject.devloss_cut(1, 1) == 1
    monkeypatch.delenv(inject.ENV_VAR)
    assert inject.devloss_cut(1, 1) == 0


def test_server_slow_and_host_simulators(monkeypatch, tmp_path):
    monkeypatch.setenv(inject.ENV_VAR, "server:slow:60")
    t0 = time.perf_counter()
    inject.maybe_slow_server("test")
    assert time.perf_counter() - t0 >= 0.055
    assert obs.metrics.counter_value("inject.server_slow") == 1
    monkeypatch.setenv(inject.ENV_VAR, "wisdom:stale-lock")
    assert inject.lock_contended()
    monkeypatch.setenv(inject.ENV_VAR, "autotune:hang:0.01")
    inject.maybe_hang_cell("cell")
    assert obs.metrics.counter_value("inject.cell_hangs") == 1
    # The checkpoint faults damage the landed file (they raised naming
    # item 13 until the persistence layer was ported): torn cuts 64 bytes.
    path = tmp_path / "ck.bin"
    path.write_bytes(b"\0" * 128)
    monkeypatch.setenv(inject.ENV_VAR, "checkpoint:torn")
    inject.maybe_taint_checkpoint(str(path))
    assert path.read_bytes() == b"\0" * 64
    path.write_bytes(b"\0" * 128)
    monkeypatch.delenv(inject.ENV_VAR)
    inject.maybe_taint_checkpoint(str(path))
    assert path.read_bytes() == b"\0" * 128


def test_guards_mode_resolution(monkeypatch):
    with pytest.raises(ValueError):
        tdfft.Config(guards="sometimes")
    assert tdfft.Config(guards="CHECK").guards == "check"
    assert tdfft.Config().resolved_guards() == "off"
    monkeypatch.setenv("DFFT_GUARDS", "enforce")
    assert tdfft.Config().resolved_guards() == "enforce"
    assert tdfft.Config(guards="off").resolved_guards() == "off"
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 8, 8), tdfft.SlabPartition(1),
                             device="cpu")
    assert plan._guard_mode == "enforce"


@pytest.mark.parametrize("n", [2, 16 ** 3, 12 * 20 * 14, 1024 ** 3])
@pytest.mark.parametrize("wire", ["native", "bf16"])
@pytest.mark.parametrize("double", [False, True])
def test_parseval_tolerance_is_jax(double, wire, n):
    from distributedfft_tpu.resilience import guards as jguards
    assert guards.parseval_tolerance(double, wire, n) == \
        jguards.parseval_tolerance(double, wire, n)


@pytest.mark.parametrize("ext, n", [(9, 16), (12, 16), (8, 15), (1, 1),
                                    (2, 2), (16, 30), (11, 20)])
def test_halved_weights_are_jax(ext, n):
    from distributedfft_tpu.resilience import guards as jguards
    got, want = guards._halved_weights(ext, n), jguards._halved_weights(ext, n)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _taint_input(dtype, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, 5, 7))
    if dtype in ("complex64", "complex128"):
        a = a + 1j * rng.standard_normal((3, 5, 7))
    return a.astype(np.float32 if dtype == "bf16" else dtype)


@pytest.mark.parametrize("dtype", ["complex64", "complex128", "float32",
                                   "bf16"])
@pytest.mark.parametrize("spec", ["wire:nan", "wire:nan@seed=61",
                                  "wire:bitflip", "wire:bitflip@seed=13",
                                  "wire:scale", "wire:scale:0.3"])
def test_taint_wire_is_jax_bit_for_bit(spec, dtype, monkeypatch):
    import jax
    import jax.numpy as jnp
    from distributedfft_tpu.resilience import inject as jinject
    monkeypatch.setenv(inject.ENV_VAR, spec)
    a = _taint_input(dtype)
    if dtype == "bf16":
        j = np.asarray(jax.jit(lambda v: jinject.taint_wire(v, "t"))(
            jnp.asarray(a).astype(jnp.bfloat16))).view(np.uint16)
        x = torch.from_numpy(a).to(torch.bfloat16)
        got = inject.taint_wire(x, "t")
        assert got.dtype == torch.bfloat16
        got = got.view(torch.int16).numpy().view(np.uint16)
    else:
        j = np.asarray(jax.jit(lambda v: jinject.taint_wire(v, "t"))(a))
        x = torch.from_numpy(a.copy())
        got = inject.taint_wire(x, "t").numpy()
        assert got.dtype == j.dtype
        j, got = j.view(np.uint8), got.view(np.uint8)
    assert np.array_equal(got, j)
    # Out of place: the caller's payload is untouched.
    same = x.view(torch.int16) if dtype == "bf16" else x
    ref = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16) \
        if dtype == "bf16" else torch.from_numpy(a)
    assert torch.equal(same, ref)


def test_taint_wire_is_identity_when_unset():
    x = torch.arange(6.0)
    assert inject.taint_wire(x, "t") is x
    assert obs.metrics.counter_value("inject.wire_faults") == 0


LADDER_CONFIGS = {
    "default": dict(comm_method="All2All"),
    "opt1": dict(comm_method="All2All", opt=1),
    "ring": dict(send_method="Ring"),
    "ring-overlap-d4-wire16": dict(send_method="RingOverlap",
                                   overlap_depth=4, wire_dtype="bf16"),
    "p2p": dict(comm_method="Peer2Peer"),
    "p2p-wire16": dict(comm_method="Peer2Peer", wire_dtype="bf16"),
    "streams": dict(comm_method="Peer2Peer", send_method="Streams",
                    streams_chunks=3),
    "a2a-pipe": dict(comm_method="All2All", overlap_subblocks=2),
    "ring-sub2-opt1": dict(send_method="Ring", overlap_subblocks=2, opt=1),
    "pencil-mixed": dict(comm_method="Peer2Peer", comm_method2="All2All",
                         send_method2="Ring"),
}


@pytest.mark.parametrize("cid", list(LADDER_CONFIGS))
def test_ladder_preview_is_jax(cid):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.resilience import fallback as jfallback
    fields = dict(LADDER_CONFIGS[cid])
    for k in ("comm_method2", "send_method2"):
        if k in fields:
            fields[k] = (jdfft.CommMethod if "comm" in k
                         else jdfft.SendMethod)(fields[k])
    jcfg = _config(jdfft, fields)
    pfields = dict(LADDER_CONFIGS[cid])
    for k in ("comm_method2", "send_method2"):
        if k in pfields:
            pfields[k] = (tdfft.CommMethod if "comm" in k
                          else tdfft.SendMethod)(pfields[k])
    cfg = _config(tdfft, pfields)
    assert fallback.ladder_preview(cfg) == jfallback.ladder_preview(jcfg)
    cur, jcur = cfg, jcfg
    while True:
        (cur, rung), (jcur, jrung) = fallback.next_rung(cur), \
            jfallback.next_rung(jcur)
        assert rung == jrung
        if cur is None:
            assert jcur is None
            break
        assert dataclasses.asdict(cur)["opt"] == jcur.opt
        assert cur.send_method.value == jcur.send_method.value
        assert cur.comm_method.value == jcur.comm_method.value
        assert cur.wire_dtype == jcur.wire_dtype


def test_fingerprint_is_jax(devices):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.resilience import guards as jguards
    for seq in ("ZY_Then_X", "Z_Then_YX"):
        for tr in ("r2c", "c2c"):
            plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 12, 10),
                                     tdfft.SlabPartition(1),
                                     tdfft.Config(opt=1, wire_dtype="bf16"),
                                     device="cpu", sequence=seq,
                                     transform=tr)
            jplan = jdfft.SlabFFTPlan(jdfft.GlobalSize(8, 12, 10),
                                      jdfft.SlabPartition(1),
                                      jdfft.Config(opt=1, wire_dtype="bf16"),
                                      sequence=seq, transform=tr)
            for d in ("forward", "inverse"):
                assert guards.fingerprint(plan, d) == \
                    jguards.fingerprint(jplan, d)


def test_single_rank_guard_spec_is_jax(devices):
    """The GuardSpec of every family on one rank equals the JAX plan's."""
    import distributedfft_tpu as jdfft
    cases = [
        (lambda pkg, **w: pkg.SlabFFTPlan(pkg.GlobalSize(8, 12, 10),
                                          pkg.SlabPartition(1), **w), 3),
        (lambda pkg, **w: pkg.SlabFFTPlan(pkg.GlobalSize(8, 12, 10),
                                          pkg.SlabPartition(1),
                                          transform="c2c", **w), 3),
        (lambda pkg, **w: pkg.PencilFFTPlan(pkg.GlobalSize(8, 12, 10),
                                            pkg.PencilPartition(1, 1), **w),
         2),
        (lambda pkg, **w: pkg.Batched2DFFTPlan(3, 8, 12, pkg.SlabPartition(1),
                                               **w), 2),
    ]
    for make, dims in cases:
        plan, jplan = make(tdfft, device="cpu"), make(jdfft)
        for d in ("forward", "inverse"):
            assert plan._guard_spec(d, dims).__dict__ == \
                jplan._guard_spec(d, dims).__dict__


def test_fallback_ladder_respects_ambient_deadline():
    """``tests/test_serve.py:400``: with an expired ambient deadline a
    failing plan with rungs left raises the ORIGINAL error after the first
    attempt."""
    from distributedfft_tpu_torch.resilience import deadline as dl

    class Boom(RuntimeError):
        pass

    class FakePlan:
        config = tdfft.Config(send_method=tdfft.SendMethod.RING)

    calls = []

    def runner():
        def run(x):
            calls.append(1)
            raise Boom("always")
        return run

    with dl.scope(dl.Deadline(time.monotonic() - 0.01)):
        with pytest.raises(Boom):
            fallback.execute(FakePlan(), "forward", None, runner)
    assert len(calls) == 1


def test_stamp_wisdom_waits_for_the_store(monkeypatch, tmp_path):
    """No store configured: nothing to stamp (as in JAX); a configured
    store (which raised naming item 11 until the store was ported) gets
    the demotion stamp on the plan's comm record; an unwritable one is
    skipped, as every wisdom write."""
    plan = tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 8, 8), tdfft.SlabPartition(1),
                             tdfft.Config(send_method=tdfft.SendMethod.RING),
                             device="cpu")
    monkeypatch.delenv("DFFT_WISDOM", raising=False)
    fallback._stamp_wisdom(plan, "send", "test")
    monkeypatch.setenv("DFFT_WISDOM", "/nonexistent/w.json")
    fallback._stamp_wisdom(plan, "send", "test")
    from distributedfft_tpu_torch.utils import wisdom
    store = tmp_path / "w.json"
    monkeypatch.setenv("DFFT_WISDOM", str(store))
    fallback._stamp_wisdom(plan, "send", "test")
    rec = wisdom.WisdomStore(str(store)).lookup(wisdom.plan_wisdom_key(plan),
                                                "comm")
    assert rec["demoted"] and rec["demoted_rung"] == "send"
    assert rec["demoted_reason"] == "test"


def test_coordinator_backoff_retries_then_succeeds(monkeypatch):
    import torch.distributed as dist
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append(kw))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 1)
    monkeypatch.setenv(inject.ENV_VAR, "coordinator:down:2")
    monkeypatch.setenv("DFFT_COORD_BACKOFF_S", "0.01")
    monkeypatch.setattr(multihost, "_INITIALIZED", False)
    assert multihost.maybe_initialize("stub:1", 1, 0, backend="gloo") == (0, 1)
    assert len(calls) == 1
    assert obs.metrics.counter_value("inject.coordinator_failures") == 2
    assert obs.metrics.counter_value("multihost.connect_retries") == 2
    monkeypatch.setattr(multihost, "_INITIALIZED", False)


def test_coordinator_down_fails_loudly_after_retries(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: None)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setenv(inject.ENV_VAR, "coordinator:down")
    monkeypatch.setenv("DFFT_COORD_RETRIES", "3")
    monkeypatch.setenv("DFFT_COORD_BACKOFF_S", "0.01")
    monkeypatch.setattr(multihost, "_INITIALIZED", False)
    with pytest.raises(inject.SimulatedFault):
        multihost.maybe_initialize("stub:1", 1, 0, backend="gloo")
    assert multihost._INITIALIZED is False
    assert obs.metrics.counter_value("multihost.connect_retries") == 2
