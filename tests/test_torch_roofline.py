"""The port's roofline model (``evalkit/roofline.py``) against the JAX
package's: every case of ``tests/test_roofline.py`` that reads no
committed file of the JAX package's chip. The multiply-add counts of the
matmul backend equal JAX's (from the port's own ``ops/mxu_fft.py``
constants); the peaks are the H100's (``PERF.md`` §2), and the bound rule
reproduces ``PERF.md`` §6's bound column and is the one ``chip_smoke.py``
applies."""

import json
import math
import os
import sys

import pytest

from distributedfft_tpu_torch.evalkit import roofline as rl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax():
    from distributedfft_tpu.evalkit import roofline as jrl
    return jrl


def test_axis_mac_counts_direct():
    jrl = _jax()
    assert rl.macs_c2c_axis(256) == 4 * 256 == jrl.macs_c2c_axis(256)
    assert rl.macs_c2c_axis(256, complex_mults=3) == 3 * 256
    assert rl.macs_r2c_axis(256) == 2 * 129 == jrl.macs_r2c_axis(256)
    assert rl.macs_c2r_axis(256) == 2 * 129 == jrl.macs_c2r_axis(256)


@pytest.mark.parametrize("n", [8, 100, 128, 256, 512, 640, 1024, 1031,
                               2048, 4096, 8192])
def test_axis_mac_counts_equal_jax(n):
    """Every axis model at direct, four-step, prime and radix-2 lengths,
    both complex-product counts: the JAX package's numbers."""
    jrl = _jax()
    for cm in (3, 4):
        for r2 in (False, True):
            assert rl.macs_c2c_axis(n, radix2=r2, complex_mults=cm) == \
                jrl.macs_c2c_axis(n, radix2=r2, complex_mults=cm)
            assert rl.macs_c2r_axis(n, radix2=r2, complex_mults=cm) == \
                jrl.macs_c2r_axis(n, radix2=r2, complex_mults=cm)
        assert rl.macs_r2c_axis(n, complex_mults=cm) == \
            jrl.macs_r2c_axis(n, complex_mults=cm)
    for dmax in (64, 512, 1024):
        assert rl.mxu_flops_roundtrip_3d(n, dmax) == \
            jrl.mxu_flops_roundtrip_3d(n, dmax)
        assert rl.mxu_flops_batched2d(4, n, dmax, radix2=True) == \
            jrl.mxu_flops_batched2d(4, n, dmax, radix2=True)
    assert rl.bluestein_axis_report(n) == jrl.bluestein_axis_report(n)


def test_axis_mac_counts_fourstep_and_radix2():
    from distributedfft_tpu_torch.ops.mxu_fft import _split_for
    assert _split_for(2048, 512) == (4, 512)
    assert _split_for(4096, 512) == (8, 512)
    assert rl.macs_c2c_axis(2048) == 4 * 512 + 4 * 4
    assert rl.macs_r2c_axis(2048) == 2 * 512 + 4 * 4
    assert rl.macs_c2r_axis(2048) == rl.macs_c2c_axis(2048)
    assert rl.macs_c2c_axis(512, radix2=True) == 4 * 128


def test_roundtrip_flops_closed_form():
    n, n_out = 256, 129
    want_macs = (n ** 3 * 2 * n_out + 4 * n * n * n_out * 4 * n
                 + n ** 3 * 2 * n_out)
    assert rl.mxu_flops_roundtrip_3d(n) == 2 * want_macs


def test_effective_peak_model():
    """The H100 model of PERF.md §2: DEFAULT one bfloat16 tensor-core pass,
    HIGH three, HIGHEST IEEE float32 on the CUDA cores."""
    assert rl.effective_peak_tflops("default") == 989.0
    assert abs(rl.effective_peak_tflops("high") - 989.0 / 3) < 1e-9
    assert rl.effective_peak_tflops("highest") == 67.0
    assert (rl.FP32_FLOPS, rl.BF16_FLOPS, rl.HBM_BYTES) == (67e12, 989e12,
                                                            3.35e12)


def test_h100_bound_reproduces_the_perf_bound_column():
    """PERF.md §6's bound column: kernel 1 on 131072 x 512 -> 257 rows and
    on the 1024^3 z rows (1048576 x 1024 -> 513), kernel 6 at 512^3 (the
    fused z-R2C and y-C2C), each read once and written once; and a 512^3
    "pallas" forward through ideal_time_ms, the same bytes."""
    def rows_bound(rows, n):
        half = n // 2 + 1
        return rl.bound(rl.fft_flops(rows, n, real=True),
                        4 * rows * n + 8 * rows * half)
    ms, by = rows_bound(131072, 512)
    assert by == "bytes" and round(ms, 5) == 0.16057
    ms, by = rows_bound(1048576, 1024)
    assert by == "bytes" and round(ms, 5) == 2.56666
    X = Y = Z = 512
    Zo = Z // 2 + 1
    ms6, by6 = rl.bound(rl.fft_flops(X * Y, Z, real=True)
                        + rl.fft_flops(X * Zo, Y),
                        4 * (X * Y * Z + 2 * X * Y * Zo))
    assert by6 == "bytes" and round(ms6, 5) == 0.32115
    assert round(rl.ideal_time_ms("512^3", "pallas", mode="forward"), 5) \
        == 0.32115
    row = rl.roofline_row(1.0, 512, "pallas", mode="forward")
    assert row["bound_by"] == "bytes" and row["model"] == "nominal+bytes"
    # operations-bound: 16 MFLOP over 67 TFLOP/s, no bytes
    assert rl.bound(67e9, 0) == (1.0, "operations")


def test_chip_smoke_takes_its_bound_from_the_module():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    for args in ((131072 * 512 * 9 * 2.5, 537919488), (1e12, 1e9)):
        assert chip_smoke.bound(*args) == rl.bound(*args)
        assert chip_smoke.matmul_bound(*args, 989e12) == rl.bound(
            *args, rate=989e12)
    assert chip_smoke.fft_flops(4096, 512, real=True) == rl.fft_flops(
        4096, 512, real=True)


def _csv(tmp_path, rows):
    p = tmp_path / "rows.csv"
    p.write_text(rl.CSV_HEADER + "\n" + "\n".join(rows) + "\n")
    return str(p)


MEASURED = ["128^3,roundtrip,matmul@high,0.5,10.0,8,chain",
            "256^3,roundtrip,matmul@high,2.0,12.0,8,chain",
            "512^3,roundtrip,matmul@high,20.0,9.0,8,chain",
            "1024^3,roundtrip,matmul@high direct(1024),400.0,5.0,2,chain",
            "4096^2x64,roundtrip,matmul@high ck=1,300.0,5.0,2,chain",
            "512^3,roundtrip,matmul-r2@high,90.0,2.0,8,chain",
            "512^3,roundtrip,xla,2.0,100.0,8,chain",
            "512^3,forward,matmul@high,10.0,9.0,8,chain"]


def test_table_from_a_measured_csv(tmp_path):
    """Every matmul-family ROUNDTRIP row translates (xla rows and one-way
    rows are skipped), with the JAX model's flops; utilizations against
    the H100 peaks; the markdown names the card and no other chip."""
    jrl = _jax()
    path = _csv(tmp_path, MEASURED)
    rows = rl.roofline_rows(path)
    jrows = jrl.roofline_rows(path)
    assert [r["size"] for r in rows] == [r["size"] for r in jrows]
    assert {"128^3", "256^3", "512^3", "1024^3", "4096^2x64"} <= {
        r["size"] for r in rows}
    assert len(rows) == 6
    for r, j in zip(rows, jrows):
        assert r["tflops_4mm"] == j["mxu_tflops_4mm"]
        assert r["tflops_3mm"] == j["mxu_tflops_3mm"]
        assert r["util_3mm"] < r["util_4mm"]
        assert r["peak_tflops"] == round(rl.effective_peak_tflops("high"), 1)
    md = rl.render_markdown(rows)
    assert "H100" in md and "512^3" in md and "utilization" in md
    assert "v5e" not in md and "TPU" not in md


def test_main_requires_a_csv(tmp_path, capsys):
    with pytest.raises(SystemExit):
        rl.main([])
    out = tmp_path / "roof.md"
    assert rl.main(["--csv", _csv(tmp_path, MEASURED), "--out",
                    str(out)]) == 0
    assert out.read_text() == rl.render_markdown(
        rl.roofline_rows(_csv(tmp_path, MEASURED)))
    assert rl.main(["--csv", _csv(tmp_path, MEASURED)]) == 0
    assert "| 512^3 | matmul@high |" in capsys.readouterr().out


def test_parse_backend_plan_suffixes():
    assert rl._parse_backend("matmul@high") == ("matmul@high", None)
    assert rl._parse_backend("matmul@high direct(1024)") == ("matmul@high",
                                                             1024)
    assert rl._parse_backend("matmul@high four-step(16x32)") == (
        "matmul@high", 32)
    assert rl._parse_backend("matmul@high ck=1") == ("matmul@high", None)
    assert rl._parse_backend("") is None
    assert rl._parse_backend("xla") is None
    assert rl._parse_backend("matmul@high mystery") is None


def test_fourstep_suffix_macs_match_measured_plan():
    from distributedfft_tpu_torch.ops.mxu_fft import _split_for
    assert _split_for(512, 32) == (16, 32)
    assert _split_for(2048, 64) == (32, 64)
    assert _split_for(4096, 64) == (64, 64)


def test_ideal_time_and_fraction_cube():
    ideal = rl.ideal_time_ms("256^3", "matmul@high")
    assert ideal is not None and ideal > 0
    assert rl.roofline_fraction(ideal, "256^3", "matmul") == 1.0
    assert abs(rl.roofline_fraction(2 * ideal, 256, "matmul") - 0.5) < 1e-3
    # the JAX model's flops at the H100 effective peak
    flops = _jax().mxu_flops_roundtrip_3d(256)
    assert math.isclose(ideal, flops / (989e12 / 3) * 1e3, rel_tol=1e-12)


def test_fraction_shape_forms_agree():
    vals = {rl.ideal_time_ms(f, "matmul")
            for f in ("256^3", "256", 256, (256, 256, 256))}
    assert len(vals) == 1


def test_fraction_modes_and_devices():
    for backend in ("matmul", "pallas"):
        rt = rl.ideal_time_ms(256, backend)
        assert abs(rl.ideal_time_ms(256, backend, mode="forward") - rt / 2) \
            < 1e-9
        assert abs(rl.ideal_time_ms(256, backend, devices=8) - rt / 8) \
            < 1e-9


def test_fraction_nominal_model_for_non_matmul():
    row = rl.roofline_row(10.0, "256^3", "xla")
    assert row["model"].startswith("nominal")
    assert row["roofline_fraction"] > 0
    # batched: 64 x 4096^2, bytes-bound, 4 + 8 bytes a point each way
    b2d = rl.ideal_time_ms("4096^2x64", "pallas")
    want = 2 * (4 * 64 * 4096 * 4096 + 8 * 64 * 4096 * 2049) / 3.35e12 * 1e3
    assert math.isclose(b2d, want, rel_tol=1e-12)


def test_fraction_direct_plan_override():
    d = rl.ideal_time_ms(1024, "matmul", direct_max=1024)
    f = rl.ideal_time_ms(1024, "matmul")
    assert d > f


def test_fraction_unmodelable_returns_none():
    assert rl.roofline_fraction(1.0, "20x16x7", "matmul") is None
    assert rl.roofline_fraction(0.0, "256^3", "matmul") is None
    assert rl.roofline_row(-1.0, "256^3", "matmul") is None
    assert rl._parse_size((20, 16, 7)) is None


def test_fraction_inverse_row_key():
    assert rl._parse_size("256:inverse") == ("cube", 256)
    assert rl._parse_size("4096^2x64") == ("b2d", (64, 4096))
    jrl = _jax()
    for s in ("256:inverse", "4096^2x64", 128, (64, 32, 32), "x"):
        assert rl._parse_size(s) == jrl._parse_size(s)


def test_tracked_fractions_reads_only_a_given_file(tmp_path):
    """No committed file: {} without a path; a given file's rows."""
    assert rl.tracked_fractions() == {}
    assert rl.tracked_fractions(str(tmp_path / "missing.json")) == {}
    p = tmp_path / "details.json"
    rec = rl.roofline_row(5.0, 512, "pallas", mode="forward")
    p.write_text(json.dumps({"roofline": {"rows": {"512^3": rec}}}))
    rows = rl.tracked_fractions(str(p))
    assert rows["512^3"]["roofline_fraction"] > 0
    assert "ideal_ms" in rows["512^3"] and "model" in rows["512^3"]


def test_nonsmooth_axes_match_jax():
    jrl = _jax()
    for shape in ((521, 521, 521), (64, 4093, 4093), (256, 256, 256)):
        assert rl.nonsmooth_axes(shape) == jrl.nonsmooth_axes(shape)
        for n in shape:
            assert rl.bluestein_flops_axis(n) == jrl.bluestein_flops_axis(n)
