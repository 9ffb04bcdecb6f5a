"""The port's bench (``ska_pst_dsp_tpu_torch.bench``) against ``bench.py``,
on the CPU at small sizes.

* Its roofline arithmetic against ``bench.py``'s ``_roofline``, read in a
  subprocess (importing ``bench.py`` turns on a process-wide JAX compile
  cache, kept here in a temporary directory): the FFT-optimal flops and the
  essential bytes per sample equal, and the HBM speed of light scaled from
  the v5e's 819 GB/s to the H100 SXM's 3.35 TB/s; the card table, and a
  card or a share of the speed of light it cannot take raising.
* ``bench_low``, ``bench_mid`` at a narrow padded geometry and ``main`` on
  the plain versions: the same code as on the card, one JSON line of
  ``bench.py``'s schema, the chain within 3e-6 of the fp64 oracle.
* The oracle round trip behind ``bench_oracle_cpu`` against the JAX
  oracle's same calls; no CUDA, no bench; the module imports with ``jax``
  unimportable.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ska_pst_dsp_tpu import oracle as jax_oracle
from ska_pst_dsp_tpu.utils import windows as jax_windows
from ska_pst_dsp_tpu.utils.rational import Rational as JaxRational
from ska_pst_dsp_tpu_torch import bench
from ska_pst_dsp_tpu_torch.ops.kernels import analysis_fused as af_mod
from ska_pst_dsp_tpu_torch.utils.config import load_config
from ska_pst_dsp_tpu_torch.utils.rational import Rational

REPO = Path(__file__).resolve().parents[1]
SXM = "NVIDIA H100 80GB HBM3"
#: a narrow zero-padded geometry of mid's OS, L and overlap: 256 channels,
#: the two-stage design at 28 taps per channel, 2 x 286720 samples
NARROW = dict(n_chan=256, taps=6273, L=512, ov=128, nu=8, de=7)
SMALL = dict(n_dat=2 ** 16, reps=(2, 1), mid_config=NARROW,
             baseline_n_dat=2 ** 16, card=SXM)
#: bench.py's _roofline in a process of its own; a second call at an HBM
#: rate of 1e12 GB/s reads its bytes per sample out of sol_mem_msps to
#: about 1e-15
_JAX_ROOFLINE = """
import json, bench
out = {}
for name in ("low", "mid"):
    plain = bench._roofline(name, 20000.0)
    bench.V5E_HBM_GBS = 1e12
    wide = bench._roofline(name, 20000.0)
    bench.V5E_HBM_GBS = 819.0
    out[name] = dict(plain, bytes_per_sample=1e15 / wide["sol_mem_msps"])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_roofline(tmp_path_factory):
    cache = tmp_path_factory.mktemp("jax_cache")
    env = dict(os.environ, JAX_PLATFORMS="cpu", SKA_PST_JAX_CACHE=str(cache))
    run = subprocess.run([sys.executable, "-c", _JAX_ROOFLINE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["low", "mid"])
def test_roofline_work_equals_bench_py(jax_roofline, name):
    ref = jax_roofline[name]
    got = bench.roofline(name, 20000.0, SXM)
    for key in ("flops_per_sample_fft_optimal", "bytes_per_sample"):
        assert got[key] == pytest.approx(ref[key], rel=1e-9), key
    # bench.py's HBM floor at the v5e's 819 GB/s, scaled to 3.35 TB/s: equal
    # within both sides' rounding to 0.1 Msamples/s
    scale = 3.35e12 / 819e9
    assert abs(got["sol_mem_msps"] - ref["sol_mem_msps"] * scale) <= 0.05 * scale + 0.05


@pytest.mark.parametrize("name", ["low", "mid"])
def test_roofline_fields(name):
    got = bench.roofline(name, 20000.0, SXM)
    hbm, fp32 = bench.PEAKS[SXM]
    assert got["sol_mem_msps"] == round(hbm / got["bytes_per_sample"] / 1e6, 1)
    assert got["sol_fp32_msps"] == pytest.approx(fp32 / got["flops_per_sample_fft_optimal"] / 1e6,
                                                 rel=1e-3)
    assert got["sol_msps"] == min(got["sol_mem_msps"], got["sol_fp32_msps"]) == got["sol_mem_msps"]
    assert got["pct_sol"] == round(100 * 20000.0 / got["sol_msps"], 2)
    assert got["tflops_effective"] == round(20000e6 * got["flops_per_sample_fft_optimal"] / 1e12, 3)
    assert got["card"] == SXM
    assert not {"flops_per_sample_matmul", "sol_mxu_msps", "tflops_executed",
                "mxu_util_pct"} & set(got)


def test_peaks_table():
    assert bench.PEAKS == {SXM: (3.35e12, 67e12), "NVIDIA H100 PCIe": (2.0e12, 51e12),
                           "NVIDIA H100 NVL": (3.9e12, 60e12)}
    assert bench.peaks("NVIDIA H100 PCIe") == (2.0e12, 51e12)
    with pytest.raises(ValueError, match="no peaks for 'NVIDIA A100"):
        bench.peaks("NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="no peaks"):
        bench.roofline("low", 100.0, "cpu")
    pcie = bench.roofline("low", 20000.0, "NVIDIA H100 PCIe")
    assert pcie["sol_mem_msps"] == round(2.0e12 / pcie["bytes_per_sample"] / 1e6, 1)


def test_pct_sol_past_100_raises():
    sol = bench.roofline("low", 1.0, SXM)["sol_msps"]
    assert bench.roofline("low", sol * 0.999, SXM)["pct_sol"] <= 100
    with pytest.raises(ValueError, match="speed of light"):
        bench.roofline("low", sol * 1.01, SXM)
    with pytest.raises(ValueError, match="speed of light"):
        bench.roofline("mid", 0.0, SXM)


def test_configs_are_bench_pys():
    assert bench.CONFIGS == {
        "low": dict(n_chan=256, taps_per_chan=12, L=256, ov=48, nu=4, de=3),
        "mid": dict(n_chan=4096, taps=100353, L=512, ov=128, nu=8, de=7),
    }


def test_mid_design_is_the_configs_cached_filter():
    # bench.py designs mid's filter (two-stage, 28 taps per channel); the
    # config's cached file holds the same coefficients bit for bit
    got = bench.design_filter(bench.CONFIGS["mid"])
    np.testing.assert_array_equal(got, load_config("mid").load_fir_filter_coeff())
    assert bench.design_filter(NARROW).size == NARROW["taps"]
    with pytest.raises(ValueError, match="no two-stage design"):
        bench.design_filter(dict(NARROW, taps=6000))


def _check_timing(r, n_dat):
    ms = r["ms_per_call"]
    assert 0 < ms["min"] <= ms["median"] <= ms["max"]
    assert r["samples_per_s"] == pytest.approx(2 * n_dat / (ms["median"] * 1e-3))
    assert (r["n_pol"], r["n_dat"]) == (2, n_dat)
    # the CPU runs the plain versions: no kernel launches, none composed
    assert set(r["launches_per_call"]) == {*bench.wrappers(), "composed_epilogues"}
    assert not any(r["launches_per_call"].values())


def test_bench_low_cpu():
    r = bench.bench_low(n_dat=2 ** 16, reps=2, device="cpu")
    _check_timing(r, 2 ** 16)
    assert (r["reps"], r["windows"]) == (2, bench.WINDOWS)
    assert 0 < r["max_err_vs_oracle"] <= bench.ORACLE_TOL


def test_bench_mid_narrow_cpu():
    r = bench.bench_mid(reps=1, device="cpu", config=NARROW)
    _check_timing(r, (2 * 128 + 4 * 256) * 224)
    err = r["max_err_vs_oracle"]
    assert 0 < err["mean"] <= bench.MID_ORACLE_MEAN and err["max"] <= bench.MID_ORACLE_MAX


def test_time_forward_counts_launches_per_call(monkeypatch):
    # a call that launches the analysis kernel twice: 2 a call over the
    # timed calls, the warm-up left out
    monkeypatch.setattr(af_mod.analysis_fused, "launches", 0)

    def fn(x):
        af_mod.analysis_fused.launches += 2
        return x

    r = bench.time_forward(fn, torch.zeros(2, 8, dtype=torch.complex64), reps=3)
    assert r["launches_per_call"]["analysis_fused"] == 2.0
    assert af_mod.analysis_fused.launches == 2 * 3 * bench.WINDOWS
    with pytest.raises(AssertionError, match="launches per call"):
        bench.check_launches("low", r["launches_per_call"])
    ok = dict.fromkeys(r["launches_per_call"], 0.0)
    ok.update(dict.fromkeys(bench.KERNELS["mid"], 1.0))
    bench.check_launches("mid", ok)
    with pytest.raises(AssertionError):
        bench.check_launches("mid", dict(ok, composed_epilogues=1.0))


def test_main_prints_one_json_line(capsys):
    got = bench.main("cpu", **SMALL)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out == json.loads(json.dumps(got))
    assert {"metric", "value", "unit", "vs_baseline", "fft_precision", "roofline", "mid",
            "ms_per_call", "max_err_vs_oracle", "launches_per_call", "baseline",
            "device"} <= set(out)
    assert (out["metric"], out["unit"], out["fft_precision"]) == (
        "low_roundtrip_throughput", "Msamples/s/chip", "fp32")
    assert out["device"] == {"name": "cpu", "power_limit_w": None}
    assert out["vs_baseline"] > 0 and out["baseline"]["n_dat"] == 2 ** 16
    mid = out["mid"]
    assert {"value", "unit", "roofline", "ms_per_call", "max_err_vs_oracle",
            "launches_per_call"} <= set(mid)
    # each leg's roofline is the one of its own geometry at its rate (the
    # narrow mid's its own); roofline() raises unless 0 < pct_sol <= 100,
    # which a CPU's rate against the card's peaks may print as 0.0
    for r, name, config in ((out, "low", None), (mid, "mid", NARROW)):
        assert r["value"] > 0
        ref = bench.roofline(name, r["value"], SXM, config)
        for key in ("pct_sol", "tflops_effective"):
            assert r["roofline"].pop(key) == pytest.approx(ref.pop(key), abs=0.01)
        assert r["roofline"] == ref
    assert out["max_err_vs_oracle"] <= bench.ORACLE_TOL
    assert mid["max_err_vs_oracle"]["max"] <= bench.MID_ORACLE_MAX


def test_main_cpu_names_its_card():
    with pytest.raises(ValueError, match="names the card"):
        bench.main("cpu", **dict(SMALL, card=None))


def test_oracle_round_trip_equals_jax_oracle():
    # the smallest power of two that gives low one inversion block
    n_dat = 2 ** 16
    c = bench.CONFIGS["low"]
    filt = bench.design_filter(c)
    x = bench.baseline_input(n_dat)
    got = bench.oracle_round_trip(x, filt, 256, Rational(4, 3), 256, 48)
    os_f = JaxRational(4, 3)
    chan = jax_oracle.polyphase_analysis(x, filt, 256, os_f)
    ref = jax_oracle.polyphase_synthesis(
        chan, 256, os_f, input_overlap=48, deripple_coeff=filt,
        temporal_taper=jax_windows.tukey_window(256, 48).astype(np.float64),
    )
    assert got.shape == ref.shape and got.shape[-1] > 0 and got.dtype == ref.dtype
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    rng = np.random.default_rng(0)
    want = (rng.standard_normal((2, 1, n_dat))
            + 1j * rng.standard_normal((2, 1, n_dat))).astype(np.complex64)
    np.testing.assert_array_equal(x, want)
    assert bench.bench_oracle_cpu(n_dat) > 0


def test_no_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    for call in (bench.main, bench.bench_low, bench.bench_mid):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_imports_with_jax_unimportable():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import ska_pst_dsp_tpu_torch.bench as b\n"
            "assert callable(b.main)\n"
            "bad = [m for m in sys.modules if m == 'ska_pst_dsp_tpu' or "
            "m.startswith('ska_pst_dsp_tpu.')]\n"
            "assert not bad, bad\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
