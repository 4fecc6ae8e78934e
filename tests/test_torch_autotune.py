"""The port's autotuner (``testing/autotune.py``) against the JAX
package's: every single-process case of ``tests/test_autotune.py`` on the
CPU (the comm races over ranks are in ``tests/test_torch_wisdom.py``'s
world), the candidate lists, labels, order and applied Configs equal to
JAX's under the same fixed timings, and a kernel error never a losing
candidate."""

import dataclasses

import numpy as np
import pytest

from distributedfft_tpu_torch import params as tp
from distributedfft_tpu_torch.ops import mxu_fft
from distributedfft_tpu_torch.ops._build import KernelError
from distributedfft_tpu_torch.testing import autotune as at

SHAPE = (16, 16, 16)
CPU = "cpu"


@pytest.fixture(scope="module")
def ranked():
    return at.autotune_local_fft(SHAPE, k=33, repeats=2, inner=2,
                                 device=CPU)


def test_all_candidates_measured(ranked):
    labels = {c.label for c in ranked}
    assert {"xla", "pallas", "matmul@high", "matmul@highest",
            "matmul-r2@high", "matmul-r2@highest"} <= labels
    assert "bluestein" not in labels        # a smooth shape: it IS "xla"
    for c in ranked:
        # The error is measured before the timing, so it is always there;
        # a timing swamped by a loaded host's noise is reported, not used.
        assert np.isfinite(c.rel_err) and np.isfinite(c.per_iter_ms), c
        assert c.error is None or c.error.startswith("degenerate timing")


def test_winner_meets_budget_and_sorts_first(ranked):
    assert ranked[0].ok
    ok_times = [c.per_iter_ms for c in ranked if c.ok]
    assert ok_times == sorted(ok_times)
    flags = [c.ok for c in ranked]
    assert flags == sorted(flags, reverse=True)


def test_budget_gates_the_real_race():
    """A budget between the precisions' errors: HIGH's three bfloat16
    passes (~1e-5 on a roundtrip) fail it, the full-precision candidates
    pass; every candidate is still measured (a timing drowned in a loaded
    host's noise fails its candidate whatever the error)."""
    ranked = at.autotune_local_fft(SHAPE, budget_rel_err=5e-6, k=17,
                                   repeats=1, inner=1, device=CPU)
    by = {c.label: c for c in ranked}
    assert by["matmul@high"].rel_err > 5e-6 and not by["matmul@high"].ok
    for label in ("xla", "pallas", "matmul@highest"):
        assert by[label].rel_err <= 5e-6, by[label]
    for c in ranked:
        assert np.isfinite(c.rel_err) and np.isfinite(c.per_iter_ms), c
        if c.error is None:
            assert c.ok == (c.rel_err <= 5e-6), c
    assert "over budget" in at.describe_failures(ranked)


def test_apply_best_returns_config(ranked):
    cfg = at.apply_best(ranked)
    assert cfg.fft_backend == ranked[0].backend
    assert cfg.mxu_precision == ranked[0].precision


def test_apply_best_raises_with_diagnosis():
    ranked = at.autotune_local_fft(SHAPE, budget_rel_err=-1.0, k=3,
                                   repeats=1, inner=1, backends=("xla",),
                                   device=CPU)
    assert not ranked[0].ok
    with pytest.raises(RuntimeError, match="no usable backend"):
        at.apply_best(ranked)


def test_double_prec_races_single_matmul_candidate():
    ranked = at.autotune_local_fft(SHAPE, k=17, repeats=3, inner=2,
                                   backends=("xla", "matmul"),
                                   double_prec=True, device=CPU)
    labels = [c.label for c in ranked]
    assert "matmul" in labels and "matmul@high" not in labels
    best = ranked[0]
    assert best.ok and best.rel_err < 1e-10


def test_describe_failures_reports_errors_not_budget():
    cands = [at.Candidate("pallas", None, error="RuntimeError: boom"),
             at.Candidate("xla", None, rel_err=0.5)]
    msg = at.describe_failures(cands)
    assert "boom" in msg and "over budget" in msg


def test_precision_default_untouched(ranked):
    assert mxu_fft.current_settings() == mxu_fft.default_settings()


def test_k_below_two_rejected():
    with pytest.raises(ValueError, match="k must be >= 2"):
        at.autotune_local_fft(SHAPE, k=1, device=CPU)


def test_direct_plan_raced_past_threshold():
    small = dataclasses.replace(mxu_fft.default_settings(), direct_max=8)
    with mxu_fft.use_settings(small):
        ranked = at.autotune_local_fft((16, 16, 16), k=17, repeats=3,
                                       inner=2, backends=("matmul",),
                                       device=CPU)
    labels = {c.label for c in ranked}
    assert "matmul@high direct(16)" in labels, labels
    direct = next(c for c in ranked if c.direct_max == 16)
    assert direct.error is None and np.isfinite(direct.per_iter_ms)
    cfg = at.apply_best(ranked)
    assert cfg.mxu_direct_max == ranked[0].direct_max
    if ranked[0].direct_max is not None:
        assert cfg.mxu_settings().direct_max == 16


def test_direct_variant_absent_below_threshold(ranked):
    assert all(c.direct_max is None for c in ranked)


def test_bluestein_joins_on_a_rough_shape():
    # k = 33, best of 2, median of 3: the chain dominates a loaded CPU's
    # noise, as the degenerate-timing note asks.
    ranked = at.autotune_local_fft((8, 8, 13), k=33, repeats=3, inner=2,
                                   backends=("xla", "bluestein"),
                                   device=CPU)
    assert {c.label for c in ranked} == {"xla", "bluestein"}
    assert all(c.ok for c in ranked)


# -- the same decisions as the JAX package under the same timings -----------

def _fixed_measure(times):
    """A ``_measure`` stand-in returning the next fixed time (both
    packages build their candidates in one order), rel_err 1e-6."""
    it = iter(times)

    def measure(shape, backend, k, repeats, inner, x, x_absmax,
                settings=None):
        return next(it), 1e-6, None

    return measure


@pytest.mark.parametrize("shape,double_prec", [
    ((4, 6, 1030), False),     # past direct_max and not smooth: every kind
    ((8, 8, 8), False), ((4, 6, 1030), True)],
    ids=["rough-1030", "smooth", "rough-f64"])
def test_local_race_decides_as_jax(monkeypatch, shape, double_prec):
    from distributedfft_tpu.testing import autotune as jat
    times = [7.0, 3.0, 9.0, 1.5, 4.0, 2.5, 8.0, 6.0, 5.0, 0.5]
    monkeypatch.setattr(at, "_measure", _fixed_measure(times))
    monkeypatch.setattr(jat, "_measure", _fixed_measure(times))
    mine = at.autotune_local_fft(shape, k=2, repeats=1, inner=1,
                                 double_prec=double_prec, device=CPU)
    theirs = jat.autotune_local_fft(shape, k=2, repeats=1, inner=1,
                                    double_prec=double_prec)
    assert [c.label for c in mine] == [c.label for c in theirs]
    assert [(c.per_iter_ms, c.ok) for c in mine] == \
        [(c.per_iter_ms, c.ok) for c in theirs]
    assert at.apply_best(mine) == tp.config_from_reference(
        dataclasses.asdict(jat.apply_best(theirs)))


def _fixed_comm(monkeypatch, mod, totals, errs):
    """``_measure_comm_candidates`` stand-in: candidate i gets forward
    and inverse of half ``totals[i]``; a compressed twin gets
    ``errs[i]`` as its wire error, gated on the budget as the real loop
    gates it (the budget's place in the arguments: JAX's loop also takes
    the mesh)."""
    at_budget = 10 if mod is at else 11

    def measure(cands, *args):
        budget = args[at_budget]
        for i, c in enumerate(cands):
            c.fwd_ms = c.inv_ms = totals[i % len(totals)] / 2
            if c.wire not in (None, "native"):
                c.wire_rel_err = errs[i % len(errs)]
                c.ok = c.wire_rel_err <= budget
                if not c.ok:
                    c.error = "over budget"
            else:
                c.ok = True
    monkeypatch.setattr(mod, "_measure_comm_candidates", measure)


@pytest.mark.parametrize("kind,part,dims,kw", [
    ("slab", "4", 3, dict(race_send=True, race_wire=True)),
    ("slab", "4", 3, dict(race_send=True)),
    ("slab", "4", 3, dict()),
    ("pencil", "2x2", 3, dict(race_send=True, race_wire=True)),
    ("pencil", "2x2", 2, dict(race_send=True)),
    ("batched2d", "4", 2, dict(race_send=True, race_wire=True,
                               overlap_depths=(2, 4), overlap_splits=(1,))),
], ids=["slab-all", "slab-send", "slab", "pencil-all", "pencil-dims2",
        "batched-all"])
def test_comm_race_decides_as_jax(monkeypatch, kind, part, dims, kw):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.testing import autotune as jat
    totals = [9.0, 4.0, 7.5, 3.0, 8.0, 2.0, 6.5, 5.5, 1.0, 2.5, 7.0]
    errs = [3e-3, 5e-2, 1e-3, 4e-2]
    _fixed_comm(monkeypatch, at, totals, errs)
    _fixed_comm(monkeypatch, jat, totals, errs)
    if kind == "pencil":
        tpart, jpart = tp.PencilPartition(2, 2), jdfft.PencilPartition(2, 2)
    else:
        tpart, jpart = tp.SlabPartition(4), jdfft.SlabPartition(4)
    base_t = tp.Config(double_prec=True, send_method=tp.SendMethod.STREAMS)
    base_j = jdfft.Config(double_prec=True,
                          send_method=jdfft.SendMethod.STREAMS)
    mine = at.autotune_comm(kind, tp.GlobalSize(16, 16, 16), tpart, base_t,
                            dims=dims, device=CPU, **kw)
    theirs = jat.autotune_comm(kind, jdfft.GlobalSize(16, 16, 16), jpart,
                               base_j, dims=dims, **kw)
    assert [c.label for c in mine] == [c.label for c in theirs]
    assert [(c.total_ms, c.ok) for c in mine] == \
        [(c.total_ms, c.ok) for c in theirs]
    assert at.apply_best_comm(mine, base_t) == tp.config_from_reference(
        dataclasses.asdict(jat.apply_best_comm(theirs, base_j)))


def test_wire_race_decides_as_jax(monkeypatch):
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.testing import autotune as jat
    for errs in ([1e-3], [5e-2]):
        _fixed_comm(monkeypatch, at, [4.0, 2.0], errs)
        _fixed_comm(monkeypatch, jat, [4.0, 2.0], errs)
        base_t = tp.Config(comm_method=tp.CommMethod.PEER2PEER, opt=1)
        base_j = jdfft.Config(comm_method=jdfft.CommMethod.PEER2PEER, opt=1)
        mine = at.autotune_wire("slab", tp.GlobalSize(8, 8, 8),
                                tp.SlabPartition(2), base_t, device=CPU)
        theirs = jat.autotune_wire("slab", jdfft.GlobalSize(8, 8, 8),
                                   jdfft.SlabPartition(2), base_j)
        assert [(c.label, c.ok) for c in mine] == \
            [(c.label, c.ok) for c in theirs]
        assert at.apply_best_comm(mine, base_t) == \
            tp.config_from_reference(dataclasses.asdict(
                jat.apply_best_comm(theirs, base_j)))


def test_apply_best_comm_raises_when_nothing_ran():
    cands = [at.CommCandidate(tp.CommMethod.ALL2ALL, None, 0,
                              error="RuntimeError: boom")]
    with pytest.raises(RuntimeError, match="no strategy ran"):
        at.apply_best_comm(cands)


def test_comm_labels_match_jax():
    """Every label form: rings at each depth and split, STREAMS, the
    pipelined all-to-all, mixed pencil methods, the wire twin."""
    from distributedfft_tpu import params as jp
    from distributedfft_tpu.testing import autotune as jat
    cases = [dict(send="RING"), dict(send="RING_OVERLAP", depth=4,
                                     subblocks=2),
             dict(send="RING_OVERLAP"), dict(send="STREAMS", chunks=3),
             dict(send="SYNC", subblocks=2), dict(wire="bf16"),
             dict(wire="native")]
    for kw in cases:
        for comm2 in (None, "PEER2PEER"):
            def make(mod, pm):
                k = dict(kw)
                if "send" in k:
                    k["send"] = getattr(pm.SendMethod, k["send"])
                c2 = getattr(pm.CommMethod, comm2) if comm2 else None
                return mod.CommCandidate(pm.CommMethod.ALL2ALL, c2, 1, **k)
            assert make(at, tp).label == make(jat, jp).label


# -- a kernel error is never a losing candidate ------------------------------

def _raise_kernel_error(*args, **kwargs):
    raise KernelError("launch of dfft_cdft failed: an illegal memory access")


def _planted(pallas, xla=(2.0, 1e-6, None)):
    """A ``_measure`` with fixed results: ``pallas`` is a result tuple or
    an exception to raise."""
    def measure(shape, backend, *a, **k):
        out = pallas if backend == "pallas" else xla
        if isinstance(out, BaseException):
            raise out
        return out
    return measure


def test_kernel_error_in_a_local_cell_propagates(monkeypatch):
    monkeypatch.setattr(at, "_measure", _raise_kernel_error)
    with pytest.raises(KernelError, match="illegal memory access"):
        at.autotune_local_fft(SHAPE, k=2, repeats=1, inner=1, device=CPU)


def test_other_cell_errors_lose_the_race(monkeypatch):
    """Any other exception fails its candidate only: the race goes on
    (off the card, where "pallas" is the kernels' plain version)."""
    monkeypatch.setattr(at, "_measure",
                        _planted(RuntimeError("no such kernel here")))
    ranked = at.autotune_local_fft((8, 8, 8), k=2, repeats=1, inner=1,
                                   backends=("xla", "pallas"), device=CPU)
    by = {c.label: c for c in ranked}
    assert not by["pallas"].ok and "no such kernel" in by["pallas"].error
    assert by["xla"].ok and ranked[0].label == "xla"


@pytest.mark.parametrize("fault", [
    RuntimeError("an illegal memory access was encountered"),
    ValueError("misaligned operand"),
    (1.0, 3e-2, None),
    (1.0, float("nan"), None),
    (-1.0, 5e-1, "degenerate timing"),
], ids=["runtime-error", "value-error", "over-budget", "nan", "degenerate"])
def test_failed_kernel_candidate_on_the_card_raises(monkeypatch, fault):
    """On the card a "pallas" cell that raises, returns a non-finite error
    or misses a budget that "xla" met is a kernel fault, not a loss."""
    monkeypatch.setattr(at, "_kernel_candidate", lambda b, d: b == "pallas")
    monkeypatch.setattr(at, "_measure", _planted(fault))
    with pytest.raises(KernelError, match="candidate pallas failed"):
        at.autotune_local_fft((8, 8, 8), k=2, repeats=1, inner=1,
                              backends=("xla", "pallas"), device=CPU)


def test_timed_out_kernel_candidate_on_the_card_raises(monkeypatch):
    monkeypatch.setattr(at, "_kernel_candidate", lambda b, d: b == "pallas")
    monkeypatch.setattr(at, "_measure", _planted((1.0, 1e-6, None)))
    real = at._call_with_timeout

    def timed(fn, label):
        if label == "pallas":
            raise at.CellTimeout("race cell exceeded 600s wall clock")
        return real(fn, label)

    monkeypatch.setattr(at, "_call_with_timeout", timed)
    with pytest.raises(KernelError, match="CellTimeout"):
        at.autotune_local_fft((8, 8, 8), k=2, repeats=1, inner=1,
                              backends=("xla", "pallas"), device=CPU)


@pytest.mark.parametrize("pallas, xla", [
    ("oom", (2.0, 1e-6, None)),
    ((1.0, 3e-2, None), (2.0, 3e-2, None)),
], ids=["out-of-memory", "budget-below-both"])
def test_kernel_candidate_losses_that_are_not_faults(monkeypatch, pallas,
                                                     xla):
    """Running out of memory, or a budget that cuFFT misses too, loses
    the race on the card as anywhere."""
    import torch
    if pallas == "oom":
        pallas = torch.cuda.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(at, "_kernel_candidate", lambda b, d: b == "pallas")
    monkeypatch.setattr(at, "_measure", _planted(pallas, xla))
    ranked = at.autotune_local_fft((8, 8, 8), k=2, repeats=1, inner=1,
                                   backends=("xla", "pallas"), device=CPU)
    by = {c.label: c for c in ranked}
    assert not by["pallas"].ok
    assert by["xla"].ok == (xla[1] <= 1e-4)


def test_kernel_fault_is_never_recorded(monkeypatch, tmp_path):
    """An "auto" plan whose "pallas" cell fails on the card raises and
    leaves no "xla" record behind."""
    import distributedfft_tpu_torch as tdfft
    monkeypatch.setattr(at, "_kernel_candidate", lambda b, d: b == "pallas")
    monkeypatch.setattr(at, "_measure", _planted((1.0, 0.5, None)))
    store = tmp_path / "w.json"
    with pytest.raises(KernelError):
        tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 8, 8), tdfft.SlabPartition(1),
                          tdfft.Config(fft_backend="auto",
                                       wisdom_path=str(store)),
                          device=CPU)
    assert not store.exists()


def test_comm_plan_failing_on_the_kernels_raises(monkeypatch):
    """A comm candidate's plan that was built and then fails on the
    card's kernels raises; one that cannot be built loses."""
    import torch
    from distributedfft_tpu_torch.testing import testcases as tc

    class Built:
        def pad_input(self, xs):
            return torch.from_numpy(xs)

    def broken(x):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(at, "_plan_runs_kernels", lambda cfg, d: True)
    monkeypatch.setattr(tc, "make_plan", lambda *a, **k: Built())
    monkeypatch.setattr(tc, "_fused_fns", lambda plan, dims: (broken, broken))
    with pytest.raises(KernelError, match="illegal memory access"):
        at.autotune_comm("slab", tp.GlobalSize(8, 8, 8), tp.SlabPartition(2),
                         tp.Config(fft_backend="pallas"), device=CPU)


def test_kernel_error_in_a_comm_cell_propagates(monkeypatch):
    from distributedfft_tpu_torch.testing import testcases as tc
    monkeypatch.setattr(tc, "make_plan", _raise_kernel_error)
    with pytest.raises(KernelError):
        at.autotune_comm("slab", tp.GlobalSize(8, 8, 8), tp.SlabPartition(2),
                         tp.Config(), device=CPU)
    with pytest.raises(KernelError):
        at.autotune_wire("slab", tp.GlobalSize(8, 8, 8), tp.SlabPartition(2),
                         tp.Config(), device=CPU)


def test_kernel_error_propagates_out_of_resolution(monkeypatch, tmp_path):
    """``fft_backend="auto"`` never resolves to "xla" behind a failed
    kernel: the plan's construction raises it (a store or none)."""
    import distributedfft_tpu_torch as tdfft
    from distributedfft_tpu_torch.utils import wisdom
    monkeypatch.setattr(at, "_measure", _raise_kernel_error)
    for kw in (dict(use_wisdom=False),
               dict(wisdom_path=str(tmp_path / "w.json"))):
        with pytest.raises(KernelError):
            tdfft.SlabFFTPlan(tdfft.GlobalSize(8, 8, 8),
                              tdfft.SlabPartition(1),
                              tdfft.Config(fft_backend="auto", **kw),
                              device=CPU)
    with pytest.raises(KernelError):
        wisdom.resolve_local_backend((8, 8, 8), enabled=False, device=CPU)
    assert not (tmp_path / "w.json").exists()


def test_cell_timeout_abandons_a_hung_cell(monkeypatch):
    """``autotune:hang`` inside a cell past $DFFT_AUTOTUNE_CELL_TIMEOUT_S:
    the cell fails with CellTimeout and the others decide."""
    from distributedfft_tpu_torch import obs
    monkeypatch.setenv("DFFT_AUTOTUNE_CELL_TIMEOUT_S", "2")
    real = at.inject.maybe_hang_cell

    def hang(label):
        if label == "pallas":
            monkeypatch.setenv("DFFT_FAULT_SPEC", "autotune:hang:10")
            try:
                real(label)
            finally:
                monkeypatch.delenv("DFFT_FAULT_SPEC")

    monkeypatch.setattr(at.inject, "maybe_hang_cell", hang)
    before = obs.metrics.counter_value("autotune.cell_timeouts")
    ranked = at.autotune_local_fft((8, 8, 8), k=5, repeats=1, inner=1,
                                   backends=("xla", "pallas"), device=CPU)
    by = {c.label: c for c in ranked}
    assert "CellTimeout" in by["pallas"].error and not by["pallas"].ok
    assert np.isfinite(by["xla"].rel_err)     # measured, not abandoned
    assert by["xla"].error is None or "CellTimeout" not in by["xla"].error
    assert obs.metrics.counter_value("autotune.cell_timeouts") == before + 1


def test_cell_timeout_setting():
    import os
    old = os.environ.pop("DFFT_AUTOTUNE_CELL_TIMEOUT_S", None)
    try:
        assert at._cell_timeout_s() == 600.0
        for raw, want in (("0", None), ("-1", None), ("2.5", 2.5),
                          ("junk", 600.0)):
            os.environ["DFFT_AUTOTUNE_CELL_TIMEOUT_S"] = raw
            assert at._cell_timeout_s() == want
    finally:
        os.environ.pop("DFFT_AUTOTUNE_CELL_TIMEOUT_S", None)
        if old is not None:
            os.environ["DFFT_AUTOTUNE_CELL_TIMEOUT_S"] = old
