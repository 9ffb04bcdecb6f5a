"""The port's CLI drivers against the JAX package's, on the CPU.

sgcht (output names, the rc of the test32 matrix and of the starvation
guard, the files it writes), test_sgcht (the same statuses; a fault is a
FAIL, never a SKIP), current_performance, at3 565, phrap and the default
report paths. The same inputs go through both packages: where a driver
draws noise (the square wave), the port's generator is given the JAX
package's samples, so the two chains see the same stream. Tolerances:
1.2e-5 x scale for a single-stage chain and 3e-5 for a cascade
(tests/test_pallas.py, tests/test_two_stage.py), 0.1 dB for at3's SNRs,
1e-6 for phrap's profile.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ska_pst_dsp_tpu.cli import at3 as jax_at3
from ska_pst_dsp_tpu.cli import current_performance as jax_cp
from ska_pst_dsp_tpu.cli import phrap as jax_phrap
from ska_pst_dsp_tpu.cli import sgcht as jax_sgcht
from ska_pst_dsp_tpu.cli import test_sgcht as jax_test_sgcht
from ska_pst_dsp_tpu.cli import test_vector as jax_test_vector
from ska_pst_dsp_tpu.models import signals as jax_signals
from ska_pst_dsp_tpu.utils.config import load_config as jax_load_config
from ska_pst_dsp_tpu_torch.cli import at3, current_performance, phrap, sgcht
from ska_pst_dsp_tpu_torch.cli import test_sgcht, test_vector
from ska_pst_dsp_tpu_torch.data_gen.channelize import create_parser as channelize_parser
from ska_pst_dsp_tpu_torch.data_gen.synthesize import create_parser as synthesize_parser
from ska_pst_dsp_tpu_torch.data_gen.generate_test_vector import (
    complex_sinusoid, time_domain_impulse,
)
from ska_pst_dsp_tpu_torch.io import dada
from ska_pst_dsp_tpu_torch.models import signals
from ska_pst_dsp_tpu_torch.models.testers import NotModeled
from ska_pst_dsp_tpu_torch.utils.config import load_config

SINGLE_TOL = 1.2e-5
CASCADE_TOL = 3e-5
FREQ = 9 / 1024  # tests/test_sgcht_matrix.py's tone: clear of every test32 seam

#: tests/test_sgcht_matrix.py's CASES
CASES = [
    ([], "plain"),
    (["--invert"], "invert"),
    (["--two_stage"], "two_stage"),
    (["--two_stage", "--invert"], "two_stage_invert"),
    (["--two_stage", "--critical"], "two_stage_critical"),
    (["--two_stage", "--critical", "--invert"], "two_stage_critical_invert"),
    (["--two_stage", "--critical", "--invert", "--combine", "4"],
     "two_stage_critical_invert_combine4"),
]
IDS = [c[1] for c in CASES]


@pytest.fixture(scope="module", autouse=True)
def _warm_configs():
    for name in ("low", "test32"):
        jax_load_config(name).load_fir_filter_coeff()
        load_config(name).load_fir_filter_coeff()


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's noise tiles replaced by the JAX package's (stream 0, the
    square wave's), so both drivers see the same samples."""
    def tiles(seed, stream, start, n, device):
        assert stream == 0
        x = jax_signals._tiled_noise(jax.random.key(seed), start, n)
        return torch.as_tensor(np.asarray(x), device=device)

    monkeypatch.setattr(signals, "_tiled_noise", tiles)


def _both(argv, cpu=True):
    """rc of the JAX sgcht and of the port's on the CPU (or the exception
    class each raised)."""
    out = []
    for mod, extra in ((jax_sgcht, []), (sgcht, ["--device", "cpu"] if cpu else [])):
        try:
            out.append(mod.run(argv + extra))
        except ValueError as exc:
            out.append(exc)
    return out


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# sgcht
# ---------------------------------------------------------------------------

FLAG_SETS = [[], ["--nbit", "8"], ["--nbit", "16", "--single"], ["--rndInput"],
             ["--rmsInput", "2.5"], ["--rndOutput"], ["--rmsOutput", "3.0"],
             ["--cfg2", "lowpsi"], ["--f_taper", "tukey"], ["--comb", "fine"],
             ["--signal", "complex_sinusoid", "--combine", "16"]]


@pytest.mark.parametrize("extra", [c[0] for c in CASES], ids=IDS)
def test_output_file_name(extra):
    for flags in FLAG_SETS:
        argv = ["--cfg", "test32"] + extra + flags
        names = [mod.output_file_name(mod.create_parser().parse_args(argv))
                 for mod in (jax_sgcht, sgcht)]
        assert names[0] == names[1], argv


def _matrix(extra, signal, **kw):
    argv = ["--signal", signal, "--cfg", "test32", "--test", "--blocks",
            str(kw.pop("blocks", 3)), "--blocksz", str(kw.pop("blocksz", 65536))]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    return argv + extra


@pytest.mark.parametrize("extra", [c[0] for c in CASES], ids=IDS)
def test_matrix_tone(extra):
    assert _both(_matrix(extra, "complex_sinusoid", frequency=FREQ)) == [0, 0]


@pytest.mark.parametrize(
    "extra", [c[0] for c in CASES if "critical_invert" not in c[1]],
    ids=[i for i in IDS if "critical_invert" not in i])
def test_matrix_impulse(extra):
    assert _both(_matrix(extra, "temporal_impulse", offset=100000)) == [0, 0]


@pytest.mark.parametrize(
    "extra", [c[0] for c in CASES if "critical_invert" in c[1]],
    ids=[i for i in IDS if "critical_invert" in i])
def test_matrix_impulse_after_critical_inversion_undefined(extra):
    got = _both(_matrix(extra, "temporal_impulse", blocks=1))
    assert isinstance(got[0], ValueError) and isinstance(got[1], sgcht.ImpulseUndefined)
    assert str(got[0]) == str(got[1])


@pytest.mark.parametrize("extra,cfg,blocksz", [
    (["--two_stage", "--invert"], "test32", 8192),  # the tester saw no sample
    ([], "low", 2048),  # every sample inside the startup-transient skip
], ids=["starved", "all_transient"])
def test_starvation_guard(extra, cfg, blocksz):
    argv = ["--signal", "complex_sinusoid", "--cfg", cfg, "--test", "--blocks", "1",
            "--blocksz", str(blocksz), "--frequency", str(FREQ)] + extra
    assert _both(argv) == [-2, -2]


@pytest.mark.parametrize("extra,tol", [(["--invert"], SINGLE_TOL),
                                       (["--two_stage", "--invert"], CASCADE_TOL)],
                         ids=["single_stage", "cascade"])
def test_write_mode(tmp_path, jax_noise, extra, tol):
    """A square wave through test32, written as DADA by each package: the
    same name and header, data within tol x scale."""
    argv = ["--signal", "square_wave", "--cfg", "test32", "--blocks", "3",
            "--blocksz", "65536"] + extra
    assert jax_sgcht.run(argv + ["--output_dir", str(tmp_path / "jax")]) == 0
    assert sgcht.run(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    name = sgcht.output_file_name(sgcht.create_parser().parse_args(argv))
    ref, ref_hdr = dada.load(str(tmp_path / "jax" / name))
    got, hdr = dada.load(str(tmp_path / "port" / name))
    assert hdr == ref_hdr
    assert got.shape == ref.shape and got.shape[-1] > 0
    assert _rel(got, ref) <= tol


def test_write_mode_appends_quantized(tmp_path, jax_noise):
    """--nbit 16 with a scale: the first block saved, the rest appended,
    quantized; equal to JAX's file but for rounding at half-integers."""
    argv = ["--signal", "square_wave", "--cfg", "test32", "--invert", "--blocks", "3",
            "--blocksz", "65536", "--nbit", "16", "--scale", "1000"]
    assert jax_sgcht.run(argv + ["--output_dir", str(tmp_path / "jax")]) == 0
    assert sgcht.run(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    name = sgcht.output_file_name(sgcht.create_parser().parse_args(argv))
    ref, ref_hdr = dada.load(str(tmp_path / "jax" / name))
    got, hdr = dada.load(str(tmp_path / "port" / name))
    assert hdr == ref_hdr and hdr["NBIT"] == "16"
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= np.sqrt(2)


def test_device_defaults_to_the_card():
    assert sgcht.create_parser().parse_args([]).device == "cuda"
    assert phrap.create_parser().parse_args([]).device == "cuda"
    assert channelize_parser().parse_args(["-i", "x", "-c", "8", "-osf", "4/3"]).device == "cuda"
    assert synthesize_parser().parse_args(["-i", "x", "-f", "64"]).device == "cuda"


def test_sweeps_default_to_the_card(tmp_path, monkeypatch):
    """test_sgcht, at3 565 and current_performance hand sgcht and the
    pipeline the card unless told otherwise."""
    seen = []
    monkeypatch.setattr(test_sgcht.sgcht, "run", lambda argv: seen.append(argv) or 0)
    assert test_sgcht.run(["-c", "test32", "--subset", "1",
                           "--report", str(tmp_path / "r.json")]) == 0
    assert seen[-1][-2:] == ["--device", "cuda"]
    monkeypatch.setattr(at3.sgcht, "run", lambda argv: seen.append(argv) or -1)
    with pytest.raises(RuntimeError, match="rc=-1"):
        at3.run_565(["--subset", "1", "--output_dir", str(tmp_path)])
    assert seen[-1][-2:] == ["--device", "cuda"]
    monkeypatch.setattr(current_performance, "test_data_pipeline",
                        lambda c, s, **kw: seen.append(kw) or (s, s[:0], {}))
    current_performance.run(["-c", "test32", "-d", "spectral", "-n", "1",
                             "--output_dir", str(tmp_path)])
    assert seen[-1] == {"backend": "torch", "device": "cuda"}


# ---------------------------------------------------------------------------
# test_sgcht
# ---------------------------------------------------------------------------

def test_test_sgcht_statuses(tmp_path, monkeypatch):
    """The whole sweep at test32 (the block sizes cut to 8192 samples): the
    same labels and statuses as the JAX package's report."""
    monkeypatch.setattr(jax_sgcht, "PRODUCTS_DIR", str(tmp_path / "jax"))
    argv = ["-c", "test32", "--blocks", "3", "--blocksz", "8192"]
    rc_jax = jax_test_sgcht.run(argv)
    report = str(tmp_path / "port.json")
    rc = test_sgcht.run(argv + ["--device", "cpu", "--report", report])
    with open(tmp_path / "jax" / "report.test_sgcht.test32.json") as f:
        ref = json.load(f)
    with open(report) as f:
        got = json.load(f)
    assert rc == rc_jax
    assert {k: v["status"] for k, v in got.items()} == {k: v["status"] for k, v in ref.items()}
    assert len(got) == 2 * len(test_sgcht.SWEEP)
    skips = [v["reason"] for v in got.values() if v["status"] == "SKIP"]
    assert skips and all("undefined" in r or "not modeled" in r for r in skips)


@pytest.mark.parametrize("exc,status", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"), "FAIL"),
    (ValueError("the cluster epilogue takes n2 = 128"), "FAIL"),
    (AssertionError("a plain version ran on the CUDA path"), "FAIL"),
    (sgcht.ImpulseUndefined("impulse testing after critical inversion is undefined"), "SKIP"),
    (NotModeled("tone in a truncated slab: not modeled"), "SKIP"),
], ids=["cuda_error", "kernel_refusal", "fallback", "undefined", "not_modeled"])
def test_test_sgcht_fault_is_fail(tmp_path, monkeypatch, exc, status):
    """Only the two refusals that mean "undefined for this combination"
    are a SKIP; anything else sgcht raises is a FAIL carrying its message."""
    def boom(argv):
        raise exc

    monkeypatch.setattr(test_sgcht.sgcht, "run", boom)
    report = str(tmp_path / "r.json")
    rc = test_sgcht.run(["-c", "test32", "--subset", "2", "--signals", "complex_sinusoid",
                         "--device", "cpu", "--report", report])
    with open(report) as f:
        got = json.load(f)
    assert [v["status"] for v in got.values()] == [status, status]
    assert rc == (1 if status == "FAIL" else 0)
    text = json.dumps(got)
    assert str(exc) in text and (status == "SKIP" or type(exc).__name__ in text)


def test_test_sgcht_mid_cascade_reason(tmp_path, monkeypatch):
    """Mid cascades are beyond the sweep's reach; the reason says so
    without claiming the reference never sweeps them."""
    monkeypatch.setattr(test_sgcht.sgcht, "run", lambda argv: 0)
    report = str(tmp_path / "r.json")
    assert test_sgcht.run(["-c", "mid", "--subset", "4", "--signals", "complex_sinusoid",
                           "--report", report]) == 0
    with open(report) as f:
        got = json.load(f)
    skips = [v["reason"] for v in got.values() if v["status"] == "SKIP"]
    assert len(skips) == 1 and "8.6 Gsamples" in skips[0]
    assert "reference" not in skips[0] and "FIR design" not in skips[0]


def test_default_report_paths(tmp_path, monkeypatch):
    """The port's reports never take the name of the JAX package's
    committed ones."""
    committed = {f"report.test_sgcht.{c}.json" for c in ("low", "lowpsi", "mid")}
    for cfgs in (["low"], ["lowpsi"], ["mid"], ["low", "mid"]):
        for device in ("cuda", "cpu", "cuda:0"):
            path = test_sgcht.default_report(cfgs, device)
            assert os.path.basename(path) not in committed
            assert path.endswith(f".{torch.device(device).type}.json")
    # at3 565's default report: products/report.at3_565.cuda.json
    monkeypatch.setattr(at3, "PRODUCTS_DIR", str(tmp_path))
    src = str(tmp_path / "baseline.dada")
    dada.save(src, np.ones((1, 1, 8), np.complex64), {"TSAMP": "1"})
    monkeypatch.setattr(at3, "_run_variant", lambda *a: src)
    assert at3.run_565(["--subset", "1", "--output_dir", str(tmp_path)]) == 0
    assert os.path.exists(tmp_path / "report.at3_565.cuda.json")


# ---------------------------------------------------------------------------
# test_vector, current_performance, at3, phrap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--cbf", "low", "--domain", "temporal", "--nstate", "3"],
    ["--cbf", "low", "--domain", "spectral", "--nstate", "2", "--nbit", "16"],
    ["--cbf", "mid", "--domain", "temporal", "--nstate", "2", "--nbit", "8"],
], ids=["low_temporal", "low_spectral_16bit", "mid_temporal_8bit"])
def test_test_vector_same_files(tmp_path, argv):
    for name, mod in (("jax", jax_test_vector), ("port", test_vector)):
        assert mod.run(argv + ["--output_dir", str(tmp_path / name)]) == 0
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == 2
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes()


@pytest.mark.parametrize("kind", ["impulse", "tone"])
def test_data_pipeline_low(kind):
    cfg, jcfg = load_config("low"), jax_load_config("low")
    n = cfg.os_factor.normalize(cfg.input_fft_length) * cfg.channels * cfg.blocks
    sig = (time_domain_impulse(n, [70001], [1]) if kind == "impulse"
           else complex_sinusoid(n, [3 * 37], [np.pi / 4]))
    _, ref, _ = jax_cp.test_data_pipeline(jcfg, sig, backend="jax")
    _, got, meta = current_performance.test_data_pipeline(cfg, sig, device="cpu")
    assert got.shape == ref.shape and got.size > 0
    assert _rel(got, ref) <= SINGLE_TOL
    assert meta == {"fir_offset": jcfg.fir_offset_direction * (3073 // 2)}


def test_current_performance_sweep(tmp_path, monkeypatch):
    """The same impulse offsets, tone frequencies and in-window flags as
    the JAX package's sweep, every in-window point at <= -60 dB."""
    monkeypatch.setattr(jax_cp, "products_dir", str(tmp_path / "jax"))
    argv = ["-c", "low", "-d", "both", "-n", "2", "--strict"]
    assert jax_cp.run(argv) == 0
    assert current_performance.run(argv + ["--device", "cpu", "--output_dir",
                                           str(tmp_path / "port")]) == 0
    with open(tmp_path / "jax" / "performance.both.low.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port" / "performance.both.low.cpu.json") as f:
        got = json.load(f)
    for domain, key in (("temporal", "offset"), ("spectral", "frequency")):
        assert [r[key] for r in got[domain]] == [r[key] for r in ref[domain]]
        assert [r.get("in_window") for r in got[domain]] == [
            r.get("in_window") for r in ref[domain]]
        assert all(r["max_spurious"] <= -60 for r in got[domain]
                   if "max_spurious" in r and r.get("in_window", True))


def test_at3_565(tmp_path, jax_noise):
    """The first three variants (baseline, rndInput, rndOutput) of the sps
    -> lowpsi critical chain at one 2-Msample block: SNRs within 0.1 dB."""
    argv = ["--blocks", "1", "--blocksz", str(2 * 1024 * 1024), "--subset", "3"]
    reports = {}
    for name, mod, extra in (("jax", jax_at3, []), ("port", at3, ["--device", "cpu"])):
        rpt = str(tmp_path / f"{name}.json")
        assert mod.run_565(argv + extra + ["--output_dir", str(tmp_path / name),
                                           "--report", rpt]) == 0
        with open(rpt) as f:
            reports[name] = json.load(f)["variants"]
    assert sorted(reports["port"]) == sorted(reports["jax"]) == [
        "baseline", "rndInput", "rndOutput"]
    for tag in ("rndInput", "rndOutput"):
        assert abs(reports["port"][tag]["snr_db"] - reports["jax"][tag]["snr_db"]) <= 0.1
        assert reports["port"][tag]["file"] == reports["jax"][tag]["file"]


def test_phrap_profile(tmp_path):
    """Both packages fold the same square-wave file."""
    src = str(tmp_path / "square_wave.dada")
    x = jax_signals.SquareWave(period=4096).generate(0, 4 * 65536)
    dada.save(src, x, {"TSAMP": "1", "CALFREQ": "244.140625"})  # period 4096 samples
    profiles = []
    for name, mod, extra in (("jax", jax_phrap, []), ("port", phrap, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.npz")
        assert mod.run(["--input", src, "--blocks", "4", "--blocksz", "65536",
                        "--output", out] + extra) == 0
        profiles.append(np.load(out))
    ref, got = profiles
    np.testing.assert_array_equal(got["hits"], ref["hits"])
    assert got["hits"].sum() == 4 * 65536
    assert np.abs(got["profile"] - ref["profile"]).max() <= 1e-6 * np.abs(ref["profile"]).max()
    p = got["profile"][0, 0]
    assert np.sort(p)[-p.size // 4:].mean() > 1.5 * np.sort(p)[: p.size // 4].mean()


def test_drivers_import_no_jax():
    """Importing every module of the slice leaves jax, the JAX package and
    matplotlib out of sys.modules (the card's machine has none of them)."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    mods = ["data_gen", "data_gen.channelize", "data_gen.synthesize", "data_gen.pipeline",
            "data_gen.dspsr_util", "cli.sgcht", "cli.test_sgcht", "cli.test_vector",
            "cli.current_performance", "cli.phrap", "cli.at3", "analysis.plots",
            "io.testbench", "utils.profiling"]
    code = ("import sys, json\n"
            + "".join(f"import ska_pst_dsp_tpu_torch.{m}\n" for m in mods)
            + "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'ska_pst_dsp_tpu', 'matplotlib'))))\n")
    env = dict(os.environ, PYTHONPATH=str(repo) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=repo, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
