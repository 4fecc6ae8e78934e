"""``dfft-torch-explain`` (``obs/explain.py``) against the JAX package's
``dfft-explain`` for the same arguments.

One 4-rank gloo world is spawned for the whole file (a module fixture):
each rank runs ``explain.main`` with ``--emulate-devices 4`` (the world
joined, each rank builds the plan; rank 0 prints, and records one
forward execution for the census and the contract line). This process
runs the JAX executable with ``--no-compile`` (its census compiles; the
port's records, so the two census sections are each package's own) on 4
of the conftest's virtual devices, and the sections are compared:

* decomposition, fft sequence, overlap schedule, wire, wisdom and
  checkpoint lines equal JAX's (the decomposition's sharding spec is
  each package's own vocabulary and is cut off);
* rendering: each line's classification (up to its " -> ") and the local
  FFT backend line equal JAX's; the text after it says what the port's
  rendering calls;
* the graph section equals JAX's, line for line;
* the port's contract line reads PASS, and its census counts the
  rendering's collectives.
"""

import contextlib
import io
import os
import pickle
import sys
import traceback

import pytest
import torch

from distributedfft_tpu_torch.obs import explain as texplain
from distributedfft_tpu_torch.parallel import multihost

P = 4
FORBIDDEN = ("jax", "jaxlib", "distributedfft_tpu")
_S = ["-nx", "20", "-ny", "16", "-nz", "16"]
CASES = {
    "slab-a2a": ["--kind", "slab"] + _S + ["-p", "4", "-comm", "All2All"],
    "slab-p2p-opt1-f64": ["--kind", "slab"] + _S + [
        "-p", "4", "-comm", "Peer2Peer", "-o", "1", "-d"],
    "slab-ring-ovl-wire16": ["--kind", "slab"] + _S + [
        "-p", "4", "-snd", "RingOverlap", "-wire", "bf16"],
    "slab-ring-d4-sub2-zyx": ["--kind", "slab"] + _S + [
        "-p", "4", "-snd", "RingOverlap", "--overlap-depth", "4",
        "--overlap-subblocks", "2", "-s", "Z_Then_YX"],
    "slab-streams-guards": ["--kind", "slab"] + _S + [
        "-p", "4", "-comm", "All2All", "-snd", "Streams",
        "--streams-chunks", "3", "--guards", "check"],
    "slab-a2a-pipe": ["--kind", "slab"] + _S + [
        "-p", "4", "-comm", "All2All", "--overlap-subblocks", "2"],
    "pencil-rings-wire16": ["--kind", "pencil"] + _S + [
        "-p1", "2", "-p2", "2", "-snd1", "Ring", "-snd2", "RingOverlap",
        "-wire", "bf16"],
    "pencil-f2-p2p": ["--kind", "pencil"] + _S + [
        "-p1", "2", "-p2", "2", "-f", "2", "-comm1", "Peer2Peer"],
    "batched-x-fused": ["--kind", "batched", "-nx", "16", "-ny", "16",
                        "-nz", "4", "--shard", "x", "-p", "4", "-wire",
                        "bf16", "-snd", "RingOverlap", "--fused-wire"],
    "batched-batch": ["--kind", "batched", "-nx", "16", "-ny", "16",
                      "-nz", "8", "--shard", "batch", "-p", "4"],
    "slab-checkpoint-wisdom": ["--kind", "slab"] + _S + [
        "-p", "4", "--checkpoint-dir", "{ck}", "--wisdom", "{wis}"],
}
COMPARED = ("decomposition", "fft sequence", "overlap schedule", "wire",
            "wisdom", "checkpoint")


def _argv(name, tmp):
    return [a.format(ck=os.path.join(tmp, "ck"),
                     wis=os.path.join(tmp, "wisdom.json"))
            for a in CASES[name]]


# ---------------------------------------------------------------------------
# the world (no JAX here)
# ---------------------------------------------------------------------------

def _rank_main(rank, addr, outdir):
    multihost.maybe_initialize(addr, P, rank, backend="gloo", timeout_s=180)
    torch.set_num_threads(1)
    results = {}
    for name in CASES:
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = texplain.main(_argv(name, outdir)
                                   + ["--emulate-devices", str(P)])
            results[name] = {"rc": rc, "text": buf.getvalue()}
        except Exception:  # noqa: BLE001 — reported by that case's test
            results[name] = {"error": traceback.format_exc()}
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN)
    if rank == 0:
        with open(os.path.join(outdir, "rank0.pkl"), "wb") as f:
            pickle.dump(results, f)
    multihost.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("explain")
    os.makedirs(outdir / "ck")
    torch.multiprocessing.start_processes(
        _rank_main, args=(multihost.local_coordinator(), str(outdir)),
        nprocs=P, start_method="spawn")
    with open(outdir / "rank0.pkl", "rb") as f:
        return str(outdir), pickle.load(f)


def _sections(text):
    """``{section title: [its indented lines]}`` of an explain report."""
    out, cur = {}, None
    for ln in text.splitlines():
        if ln.startswith("  ") and cur is not None:
            out[cur].append(ln)
        elif ln and not ln.startswith(" ") and ln.endswith(":"):
            cur = ln[:-1].split(" (")[0]
            out[cur] = []
        else:
            cur = None
    return out


def _mine(world, name):
    res = world[1][name]
    if "error" in res:
        pytest.fail(res["error"])
    assert res["rc"] == 0
    return res["text"]


def _jax(world, name, capsys):
    from distributedfft_tpu.obs import explain as jexplain
    capsys.readouterr()
    assert jexplain.main(_argv(name, world[0]) + ["--no-compile"]) == 0
    return capsys.readouterr().out


def test_ranks_import_no_jax(world):
    assert world[1]["modules"] == []


@pytest.mark.parametrize("name", list(CASES))
def test_sections_equal_jax(world, devices, capsys, name):
    mine = _sections(_mine(world, name))
    theirs = _sections(_jax(world, name, capsys))
    for sec in COMPARED:
        assert (sec in mine) == (sec in theirs), sec
        if sec not in mine:
            continue
        a, b = mine[sec], theirs[sec]
        if sec == "decomposition":
            a = [ln.split("  spec ")[0] for ln in a]
            b = [ln.split("  spec ")[0] for ln in b]
        assert a == b, sec
    assert [ln.split(" -> ")[0] for ln in mine["rendering"]] == \
        [ln.split(" -> ")[0] for ln in theirs["rendering"]]
    assert mine["graph"] == theirs["graph"]


@pytest.mark.parametrize("name", list(CASES))
def test_census_and_contract_line(world, name):
    text = _mine(world, name)
    sec = _sections(text)
    census, contract = sec["op census"]
    assert contract.startswith("  contract: PASS ("), contract
    counts = dict(kv.split(": ") for kv in census.split("  ") if kv)
    if name in ("slab-a2a", "slab-streams-guards"):
        want = "3" if "streams" in name else "1"
        assert counts["all_to_all"] == want
    if name == "slab-a2a-pipe":
        assert counts["all_to_all_start"] == "2"
    if "ring" in name and name.startswith("slab"):
        assert int(counts["send"]) >= P - 1
    if name == "batched-batch":
        assert counts["all_to_all"] == counts["send"] == "0"
    assert "roofline" in " ".join(sec)


def test_no_compile_leaves_the_contract_unverified(capsys):
    rc = texplain.main(["--kind", "slab", "-nx", "16", "-ny", "16", "-nz",
                        "16", "--no-compile", "--emulate-devices", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "contract: unverified" in out
    assert "op census: skipped (--no-compile)" in out


def test_profile_section_on_one_rank(capsys):
    """``--profile``: the stage profile of the forward direction, every
    node of the single-device graph measured (on the CPU: no gap)."""
    rc = texplain.main(["--kind", "slab", "-nx", "16", "-ny", "16", "-nz",
                        "16", "--profile", "--profile-iters", "2",
                        "--fft-backend", "pallas", "--emulate-devices", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    sec = _sections(out)
    prof = sec["stage profile"]
    assert prof[0].startswith("  slab/forward: total ")
    assert any(ln.startswith("  local_fft:1 ") and "ideal " in ln
               and "gap" not in ln for ln in prof)
    roof = sec["roofline"]
    assert any("H100 ideal" in ln for ln in roof)
    assert not any(w in out for w in ("v5e", "TPU", "MXU"))
