"""The port's executables of the serve layer against the JAX package's:
``dfft-torch-serve`` (``serve/cli.py``) and ``dfft-torch-solve``
(``solvers/driver.py``).

* both flag surfaces equal the JAX ``dfft-serve`` / ``dfft-solve`` ones;
  every fleet flag raises naming ROADMAP item 14's second part;
* ``--drive`` on one rank offers the JAX drive's schedule (same seed,
  same outcome counts) and on four emulated ranks (``-p 4 --shard x``)
  serves every request;
* ``--http`` (a subprocess on an ephemeral local port): ``/healthz``,
  ``/readyz``, ``/metrics`` (valid exposition), ``POST /fft`` within
  1e-4 of numpy, the structured 400 and 404, and SIGTERM drains to exit 0;
* ``dfft-torch-solve``: an interrupted run resumed from its checkpoint
  writes ``--out`` bit for bit as the uninterrupted run, on one rank and
  on four, and the final field agrees with the JAX driver's within 1e-5.
"""

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from distributedfft_tpu_torch.obs import promexp
from distributedfft_tpu_torch.serve import cli as tcli
from distributedfft_tpu_torch.solvers import driver as tdriver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _surface(ap):
    return {tuple(a.option_strings): (a.dest, a.default, a.choices,
                                      type(a).__name__, a.required)
            for a in ap._actions if a.option_strings != ["-h", "--help"]}


def _run(main, argv):
    """(exit code, printed text) of ``main(argv)`` in this process, the
    signal handlers it installs put back."""
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    return rc, buf.getvalue()


def _last_json(text):
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


# ---------------------------------------------------------------------------
# flag surfaces
# ---------------------------------------------------------------------------

def test_serve_flag_surface_matches_jax():
    from distributedfft_tpu.serve.cli import build_parser
    assert _surface(tcli.build_parser()) == _surface(build_parser())


def test_solve_flag_surface_matches_jax():
    from distributedfft_tpu.solvers.driver import build_parser
    assert _surface(tdriver.build_parser()) == _surface(build_parser())


@pytest.mark.parametrize("flag,value", [
    ("--workers", "2"), ("--worker-devices", "1,0"),
    ("--worker-backend", "stub"), ("--heartbeat-interval-s", "1"),
    ("--heartbeat-k", "5"), ("--worker-inflight", "2"),
    ("--tenant-weights", "gold=3"), ("--tenants", "gold,free"),
    ("--autoscale", "1:2"), ("--scale-cooldown-s", "1")])
def test_fleet_flags_raise_naming_their_item(flag, value):
    assert {f for f, _, _ in tcli.FLEET_FLAGS} >= {flag}
    with pytest.raises(NotImplementedError, match="item 14, second part"):
        tcli.main(["--drive", flag, value, "--emulate-devices", "1"])


# ---------------------------------------------------------------------------
# --drive
# ---------------------------------------------------------------------------

def test_drive_offers_the_jax_schedule(devices):
    from distributedfft_tpu.serve.cli import main as jmain
    argv = ["--drive", "--requests", "16", "--rate", "80", "--shapes",
            "16x16,12x8", "--transforms", "r2c,c2c", "--seed", "3",
            "--latency-budget-ms", "100000"]
    rc, text = _run(tcli.main, argv + ["--emulate-devices", "1"])
    jrc, jtext = _run(jmain, argv)
    assert rc == jrc == 0
    mine, theirs = _last_json(text), _last_json(jtext)
    assert mine["offered"] == theirs["offered"] == 16
    assert mine["outcomes"] == theirs["outcomes"]
    assert mine["outcomes"]["ok"] == 16
    assert mine["health_status"] == "ok"
    assert set(mine) == set(theirs)


def test_drive_on_four_ranks(tmp_path):
    rc, text = _run(tcli.main, [
        "--drive", "--requests", "10", "--rate", "60", "--shapes",
        "16x16,16x16x16", "--emulate-devices", "4", "-p", "4", "--shard",
        "x", "--health-out", str(tmp_path / "h.json")])
    assert rc == 0
    health = json.loads((tmp_path / "h.json").read_text())
    assert health["role"] == "leader"
    assert health["counters"]["served"] >= 10
    assert health["counters"]["batch_failures"] == 0


# ---------------------------------------------------------------------------
# --http
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _post(url, body, headers):
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def test_http_surface(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedfft_tpu_torch.serve.cli",
         "--http", str(port), "--emulate-devices", "1"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        t0 = time.monotonic()
        while True:
            try:
                code, _, body = _get(base + "/healthz")
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.communicate()[1][-2000:]
                assert time.monotonic() - t0 < 120
                time.sleep(0.2)
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, _, body = _get(base + "/readyz")
        assert code == 200 and json.loads(body)["ready"] is True
        x = np.random.default_rng(9).random((32, 24)).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, x)
        code, hdrs, body = _post(base + "/fft", buf.getvalue(),
                                 {"X-DFFT-Transform": "r2c"})
        assert code == 200 and hdrs["X-DFFT-Trace"]
        got = np.load(io.BytesIO(body))
        np.testing.assert_allclose(got, np.fft.rfft2(x), rtol=1e-4,
                                   atol=1e-4 * np.abs(got).max())
        code, _, body = _post(base + "/fft", b"not an npy",
                              {"X-DFFT-Transform": "r2c"})
        assert code == 400 and json.loads(body)["error"] == "bad_request"
        assert _get(base + "/nope")[0] == 404
        code, hdrs, body = _get(base + "/metrics")
        assert code == 200
        assert hdrs["Content-Type"] == promexp.CONTENT_TYPE
        text = body.decode()
        assert promexp.validate_exposition(text) > 0
        assert "dfft_serve_requests_total 1" in text   # the bad body never admits
        assert "dfft_serve_e2e_ms_count 1" in text
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    assert "graceful drain" in out


# ---------------------------------------------------------------------------
# dfft-torch-solve
# ---------------------------------------------------------------------------

SOLVE = ["--kind", "ns2d", "--n", "16", "--batch", "2", "--dt", "2e-3"]


def _solve(tmp_path, extra, steps, tag):
    rc, text = _run(tdriver.main, SOLVE + ["--steps", str(steps)] + extra)
    assert rc == 0, text
    return _last_json(text)


@pytest.mark.parametrize("ranks", [1, 4])
def test_solve_resume_bit_exact(tmp_path, ranks):
    emu = ["--emulate-devices", str(ranks)]
    if ranks > 1:
        emu += ["-p", str(ranks), "--shard", "x"]
    ck = str(tmp_path / "ck")
    a = tmp_path / "a.npy"
    b = tmp_path / "b.npy"
    if ranks == 1:
        s = _solve(tmp_path, emu + ["--out", str(a)], 6, "a")
        assert s["step"] == 6 and s["out"] == str(a)
        s1 = _solve(tmp_path, emu + ["--checkpoint-dir", ck,
                                     "--checkpoint-policy", "steps:2"], 3,
                    "first")
        assert s1["step"] == 3 and s1["checkpoints"] >= 1
        s2 = _solve(tmp_path, emu + ["--checkpoint-dir", ck, "--resume",
                                     "--out", str(b)], 6, "resume")
        assert s2["restored_from"] == 3 and s2["step"] == 6
    else:
        # The spawned ranks print in their own processes: read the files.
        for extra, steps in ((["--out", str(a)], 6),
                             (["--checkpoint-dir", ck], 3),
                             (["--checkpoint-dir", ck, "--resume", "--out",
                               str(b)], 6)):
            rc, _ = _run(tdriver.main, SOLVE + ["--steps", str(steps)]
                         + emu + extra)
            assert rc == 0
    assert np.load(a).tobytes() == np.load(b).tobytes()
    assert np.load(a).shape == (2, 16, 16)


def test_solve_matches_the_jax_driver(tmp_path, devices):
    from distributedfft_tpu.solvers.driver import main as jmain
    mine, theirs = tmp_path / "port.npy", tmp_path / "jax.npy"
    rc, text = _run(tdriver.main, SOLVE + ["--steps", "5", "--out",
                                           str(mine), "--emulate-devices",
                                           "1"])
    assert rc == 0
    jrc, jtext = _run(jmain, SOLVE + ["--steps", "5", "--out", str(theirs)])
    assert jrc == 0
    s, js = _last_json(text), _last_json(jtext)
    assert {k: s[k] for k in s if k != "out"} == \
        {k: js[k] for k in js if k != "out"}
    got, want = np.load(mine), np.load(theirs)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_solve_resume_refuses_without_a_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="no restorable checkpoint"):
        _run(tdriver.main, SOLVE + ["--steps", "2", "--checkpoint-dir",
                                    str(tmp_path / "empty"), "--resume",
                                    "--emulate-devices", "1"])
    with pytest.raises(SystemExit, match="needs --checkpoint-dir"):
        _run(tdriver.main, SOLVE + ["--resume", "--emulate-devices", "1"])
