"""The port's verification harness (ska_pst_dsp_tpu_torch.verify) against
the JAX package's, on the CPU.

The same seeded inputs go through both packages: the JAX harness on its
``jax`` backend (composed XLA on the CPU), the port's on ``torch`` with
``device="cpu"``, where the fused drop-ins run their plain versions. Where
a harness draws noise (the square wave of the cross-implementation suite,
the dedispersion test and the matrix) the port is given the JAX package's
samples. Tolerances: the comparator, the parser and the metrics give equal
results; purity's difference fields within 1.2e-5 x scale, each spurious
dB field within 0.5 dB of JAX's where JAX's is above -100 dB and both below
-60 where JAX's is; channelized files within 8e-6 x scale and inversions
within 1.2e-5 x scale of JAX's (tests/test_pallas.py); dedispersion and the
12-case matrix within 0.5 dB, with the same gates. Every report the port
writes by default is named ``.cpu.json`` or ``.cuda.json``, and no committed
``products/`` file changes.
"""

import hashlib
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ska_pst_dsp_tpu import data_gen as jax_dg
from ska_pst_dsp_tpu.models import signals as jax_signals
from ska_pst_dsp_tpu.utils.config import load_config as jax_load_config
from ska_pst_dsp_tpu.verify import common as jax_common
from ska_pst_dsp_tpu.verify import comparator as jax_comparator
from ska_pst_dsp_tpu.verify import purity as jax_purity
from ska_pst_dsp_tpu.verify import test_dedispersion as jax_dedisp
from ska_pst_dsp_tpu.verify import verify_dspsr_pfb_inversion as jax_matrix
from ska_pst_dsp_tpu_torch import data_gen as dg
from ska_pst_dsp_tpu_torch.analysis import process_test_vectors
from ska_pst_dsp_tpu_torch.design import fir
from ska_pst_dsp_tpu_torch.io import dada
from ska_pst_dsp_tpu_torch.models import signals
from ska_pst_dsp_tpu_torch.utils.config import load_config
from ska_pst_dsp_tpu_torch.utils.rational import Rational
from ska_pst_dsp_tpu_torch.verify import (
    common, comparator, purity, test_backends, test_cross_implementation,
    test_dedispersion, util, verify_dspsr_pfb_inversion,
)

REPO = Path(__file__).resolve().parents[1]
ANALYSIS_TOL = 8e-6
SYNTHESIS_TOL = 1.2e-5
DB_TOL = 0.5
#: tests/test_reference_anchor.py's vector: 442368 samples, tone bin
#: 377475, impulse at 0.11 of the stream
ANCHOR_N, ANCHOR_BIN, ANCHOR_OFFSET = 442368, 377475, 0.11


def _products_digest():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / "products").glob("*")) if p.is_file()}


@pytest.fixture(scope="module", autouse=True)
def _committed_products_unchanged():
    """No run of this module changes a file of products/."""
    for name in ("low", "test32"):
        jax_load_config(name).load_fir_filter_coeff()
        load_config(name).load_fir_filter_coeff()
    before = _products_digest()
    yield
    assert _products_digest() == before


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's noise tiles replaced by the JAX package's (stream 0, the
    square wave's), so both harnesses see the same samples."""
    def tiles(seed, stream, start, n, device):
        assert stream == 0
        x = jax_signals._tiled_noise(jax.random.key(seed), start, n)
        return torch.as_tensor(np.asarray(x), device=device)

    monkeypatch.setattr(signals, "_tiled_noise", tiles)


@pytest.fixture
def products(tmp_path, monkeypatch):
    """Every report of either package goes to tmp_path/<package>."""
    for mod in (purity, test_backends, test_cross_implementation, test_dedispersion,
                verify_dspsr_pfb_inversion):
        monkeypatch.setattr(mod, "products_dir", str(tmp_path / "port"))
    for mod in (jax_purity, jax_dedisp, jax_matrix):
        monkeypatch.setattr(mod, "products_dir", str(tmp_path / "jax"))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    return tmp_path


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.size > 0
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _same_db(got, ref):
    """A dB field of the port's against JAX's: within 0.5 dB where JAX's is
    above -100 dB, and below -60 where JAX's is."""
    if ref > -100:
        assert abs(got - ref) <= DB_TOL, (got, ref)
    if ref < -60:
        assert got < -60, (got, ref)


# ---------------------------------------------------------------------------
# comparator, common, util
# ---------------------------------------------------------------------------

def _comparators(mod):
    m = mod.MultiDomainComparator(domains={"time": mod.TimeDomainComparator("time"),
                                           "freq": mod.FrequencyDomainComparator("freq")})
    m.freq.domain = [0, 48]
    m.operators["this"] = lambda a: a
    m.operators["diff"] = lambda a, b: a - b
    m.products["mean"] = lambda a: float(np.mean(np.abs(a)))
    m.products["max_spurious"] = util.max_spurious
    return m


def test_comparator_equal():
    rng = np.random.default_rng(90)
    arrays = [rng.standard_normal(64) + 1j * rng.standard_normal(64) for _ in range(3)]
    for domain in ("time", "freq"):
        ops, prods = getattr(_comparators(comparator), domain)(*arrays)
        jops, jprods = getattr(_comparators(jax_comparator), domain)(*arrays)
        for name in ("this", "diff"):
            assert dict(prods[name].items()) == dict(jprods[name].items())
            for key, val in ops[name].items():
                np.testing.assert_array_equal(val, jops[name][key])


def test_comparator_single_domain():
    # tests/test_verify.py's TestComparator, on the port
    c = comparator.TimeDomainComparator("time")
    c.operators["this"] = lambda a: a
    c.operators["diff"] = lambda a, b: a - b
    c.products["mean"] = lambda a: float(np.mean(np.abs(a)))
    ops, prods = c(np.ones(10), np.zeros(10))
    assert prods["diff"][0, 1]["mean"] == 1.0 and prods["this"][0]["mean"] == 1.0
    np.testing.assert_array_equal(ops["diff"][1, 0], -np.ones(10))
    with pytest.raises(TypeError):
        c.operators["bad"] = 1


def test_parser_as_jax_with_device():
    argv = ["-t", "-f", "-n", "7", "-c", "mid", "--save-output", "-b", "numpy", "-v"]
    got = vars(common.create_parser().parse_args(argv))
    ref = vars(jax_common.create_parser().parse_args(argv))
    assert got.pop("device") == "cuda" and got == ref
    assert common.create_parser().parse_args(["--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("plot", ["plot_time_domain_comparison",
                                  "plot_freq_domain_comparison"])
def test_plots(plot):
    pytest.importorskip("matplotlib")
    from ska_pst_dsp_tpu.verify import util as jax_util

    x = np.exp(2j * np.pi * 3 * np.arange(32) / 32)
    t = {"this": {0: x, 1: 0.5 * x}, "diff": {0: 0.5 * x}}
    args = (t, t) if plot == "plot_freq_domain_comparison" else (t,)
    fig, axes = getattr(util, plot)(*args, labels=["a", "b"])
    jfig, jaxes = getattr(jax_util, plot)(*args, labels=["a", "b"])
    assert len(axes) == len(jaxes)
    assert [a.get_title() for a in axes] == [a.get_title() for a in jaxes]
    for a, b in zip(axes, jaxes):
        for la, lb in zip(a.get_lines(), b.get_lines()):
            np.testing.assert_array_equal(la.get_ydata(), lb.get_ydata())


# ---------------------------------------------------------------------------
# purity
# ---------------------------------------------------------------------------

def _purity_pair(out, cfg_kw, filt_path=None):
    """The JAX harness (jax backend) and the port's (torch on the CPU) on the
    same geometry, both channelizing with the filter at ``filt_path``."""
    kw = dict(n_test=2, blocks=3, output_dir=out, make_plots=False, **cfg_kw)
    jp = jax_purity.TestPurity(backend={"test_vectors": "numpy", "channelize": "jax",
                                        "synthesize": "jax"}, **kw)
    pp = purity.TestPurity(backend={"test_vectors": "numpy", "channelize": "torch",
                                    "synthesize": "torch"}, device="cpu", **kw)
    n_chan, os_f = kw["channels"], str(kw["os_factor"])
    jp.channelizer = jax_dg.channelize(backend="jax", channels=n_chan, os_factor_str=os_f,
                                       fir_filter_path=filt_path)
    pp.channelizer = dg.channelize(backend="torch", channels=n_chan, os_factor_str=os_f,
                                   fir_filter_path=filt_path, device="cpu")
    jp.pipeline = jax_dg.pipeline(jp.generator, jp.channelizer, lambda a, **k: a,
                                  output_dir=out)
    pp.pipeline = dg.pipeline(pp.generator, pp.channelizer, lambda a, **k: a,
                              output_dir=out)
    return jp, pp


def _same_purity(got, ref, n):
    assert [r["arg"] for r in got] == [r["arg"] for r in ref]
    for g, r in zip(got, ref):
        assert abs(g["mean_diff"] - r["mean_diff"]) <= SYNTHESIS_TOL
        assert abs(g["total_diff"] - r["total_diff"]) <= SYNTHESIS_TOL * n
        for key in ("max_spurious_power", "total_spurious_power", "mean_spurious_power"):
            _same_db(g[key], r[key])


def test_purity_surrogate(products):
    # tests/test_verify.py's 64-channel surrogate (OS 4/3, L 128, overlap 24)
    out = str(products / "files")
    os.makedirs(out)
    filt = fir.design_pfb_fir_filter(64, Rational(4, 3), 12)
    filt_path = os.path.join(out, "filt.npy")
    np.save(filt_path, filt)
    jp, pp = _purity_pair(out, dict(os_factor="4/3", input_fft_length=128,
                                    input_overlap=24, fft_window="tukey", deripple=True,
                                    channels=64, fir_filter_taps=filt.size), filt_path)
    for sweep in ("temporal_purity", "spectral_purity"):
        _same_purity(getattr(pp, sweep)(), getattr(jp, sweep)(), pp.n_samples)
    mid = [r for r in pp.report["test_time_domain_impulse"]
           if 0 < r["arg"] < pp.n_samples - 1]
    assert all(r["max_spurious_power"] < -60 for r in mid)
    path = pp.finish()
    assert path.endswith(".cpu.json") and os.path.dirname(path) == str(products / "port")
    with open(path) as f:
        assert set(json.load(f)) == {"test_time_domain_impulse", "test_complex_sinusoid"}


def test_purity_production_adversarial(products):
    # tests/test_verify.py's production low config with the block-seam
    # impulses: the seam, seam -+ 1, seam -+ output overlap
    cfg = load_config("low")
    out = str(products / "files")
    jp, pp = _purity_pair(out, dict(
        os_factor=str(cfg.os_factor), input_fft_length=cfg.input_fft_length,
        input_overlap=cfg.input_overlap, fft_window=cfg.temporal_taper,
        deripple=cfg.deripple, channels=cfg.channels,
        fir_filter_taps=cfg.fir_filter_taps), cfg.fir_filter_path)
    keep = pp.block_size - 2 * pp.output_sample_shift
    seam = pp.total_sample_shift + keep
    offsets = [seam, seam - 1, seam + 1, seam - pp.output_sample_shift,
               seam + pp.output_sample_shift]
    for p in (jp, pp):
        p.time_domain_args["offset"] = offsets
    got, ref = pp.temporal_purity(), jp.temporal_purity()
    _same_purity(got, ref, pp.n_samples)
    assert all(-120 < r["max_spurious_power"] < -60 for r in got)


def test_purity_cli_backends(products, monkeypatch):
    # the config file names the JAX package's backend: the port reads it as
    # torch; --backend overrides
    seen = []
    monkeypatch.setattr(purity.TestPurity, "finish", lambda self: seen.append(
        (dict(self.channelizer.keywords), self.synthesizer.keywords["backend"])) or "")
    purity.run(["-c", "low", "-n", "2", "--device", "cpu"])
    purity.run(["-c", "low", "-n", "2", "-b", "numpy"])
    assert seen[0][0]["backend"] == "torch" and seen[0][0]["device"] == "cpu"
    assert seen[0][1] == "torch" and seen[1][0]["device"] == "cuda"
    assert seen[1][0]["backend"] == "numpy" and seen[1][1] == "numpy"
    assert purity.port_backend("jax") == "torch" and purity.port_backend("numpy") == "numpy"


# ---------------------------------------------------------------------------
# test_backends, test_cross_implementation
# ---------------------------------------------------------------------------

def test_backends_low(products):
    cfg = load_config("low")
    out = str(products / "files")
    report = test_backends.compare_channelizer_backends(cfg, output_dir=out, device="cpu")
    assert report["mean_close"] == 1.0 and report["use_padded"] is False
    tone = next(f for f in os.listdir(out) if f.startswith("complex_sinusoid"))
    ref = jax_dg.channelize(os.path.join(out, tone), channels=cfg.channels,
                            os_factor_str=str(cfg.os_factor),
                            fir_filter_path=cfg.fir_filter_path, backend="jax",
                            output_dir=out, output_file_name="chan.jax.dump")
    got = dada.DADAFile(os.path.join(out, "chan.torch.dump")).load_data()
    assert _rel(got.data, ref.data) <= ANALYSIS_TOL
    assert test_backends.run(["-c", "low", "--device", "cpu"]) == 0
    assert os.listdir(products / "port") == ["report.backends.cpu.json"]


@pytest.mark.parametrize("variant", ["time", "freq", "pulsar"])
def test_cross_implementation_anchor(products, jax_noise, variant):
    cfg, jcfg = load_config("low"), jax_load_config("low")
    out = str(products / "files")
    report = test_cross_implementation.run_suite(
        cfg, n_bins=ANCHOR_N, do_time=variant == "time", do_freq=variant == "freq",
        do_pulsar=variant == "pulsar", output_dir=out, offset=ANCHOR_OFFSET,
        freq=ANCHOR_BIN, device="cpu")
    (entries,) = report.values()
    assert len(entries) == 1 and entries[0]["mean"] > 0.999
    assert entries[0]["n"] >= 350_000
    if variant == "pulsar":
        # the port's pulsar file holds the JAX package's samples
        x = np.asarray(jax_signals.SquareWave(period=1024, duty_cycle=0.1, on_amp=4.0,
                                              off_amp=0.25, seed=3).generate(0, ANCHOR_N))
        vec = dada.DADAFile(os.path.join(out, "simulated_pulsar.dump")).load_data()
        np.testing.assert_array_equal(vec.data_pft, np.repeat(x, cfg.n_pol, axis=0))
    vector = next(os.path.join(out, f) for f in os.listdir(out)
                  if f.startswith(("time_domain_impulse", "complex_sinusoid",
                                   "simulated_pulsar")))
    chan = os.path.join(out, "chan.dump")
    ref_chan = jax_dg.channelize(vector, channels=jcfg.channels,
                                 os_factor_str=str(jcfg.os_factor),
                                 fir_filter_path=jcfg.fir_filter_path, backend="jax",
                                 output_dir=out, output_file_name="chan.jax.dump")
    assert _rel(dada.DADAFile(chan).load_data().data, ref_chan.data) <= ANALYSIS_TOL
    ref_inv = jax_dg.synthesize(chan, input_fft_length=jcfg.input_fft_length,
                                input_overlap=jcfg.input_overlap,
                                fft_window_str=jcfg.temporal_taper,
                                apply_deripple=jcfg.deripple, backend="jax",
                                output_dir=out, output_file_name="inv.jax.dump")
    got = dada.DADAFile(os.path.join(out, "inv.torch.dump")).load_data()
    assert _rel(got.data, ref_inv.data) <= SYNTHESIS_TOL


def test_cross_implementation_cli(products, jax_noise):
    assert test_cross_implementation.run(["-c", "low", "-t", "--device", "cpu"]) == 0
    with open(products / "port" / "report.cross_impl.cpu.json") as f:
        report = json.load(f)
    assert list(report) == ["test_time_domain_impulse"]
    assert report["test_time_domain_impulse"][0]["offset"] == 0.11


# ---------------------------------------------------------------------------
# dedispersion and the 12-case matrix
# ---------------------------------------------------------------------------

def test_dedispersion_low(products, jax_noise):
    ref = jax_dedisp.run_dedispersion_test(jax_load_config("low"))
    got = test_dedispersion.run_dedispersion_test(load_config("low"), device="cpu")
    assert got["n_compared"] == ref["n_compared"] and got["dm"] == ref["dm"]
    for key in ("mean_diff_db", "max_diff_db", "folded_mean_diff_db"):
        _same_db(got[key], ref[key])
    assert (got["mean_diff_db"] < -50) == (ref["mean_diff_db"] < -50) is True
    assert test_dedispersion.run(["-c", "low", "--device", "cpu"]) == 0
    assert os.listdir(products / "port") == ["report.dedispersion.cpu.json"]


def test_dedispersion_mid_alignment():
    # the zero-padded analysis removes its own group delay: the port aligns
    # the inverted stream with that shift (the JAX test_dedispersion takes
    # the unpadded one, 50177 samples off at mid)
    from ska_pst_dsp_tpu_torch.utils import geometry

    src = inspect.getsource(test_dedispersion.run_dedispersion_test)
    assert "padded=use_padded" in src
    cfg = load_config("mid")
    args = (cfg.channels, cfg.os_factor, cfg.fir_filter_taps, cfg.input_overlap)
    assert (geometry.total_sample_shift(*args) - geometry.total_sample_shift(
        *args, padded=True)) == 50177


def test_matrix_low(products, jax_noise, monkeypatch):
    # the port takes a channel group's deripple at the analysis filterbank's
    # channel count (the JAX harness takes it at the group's, the reciprocal
    # of the filter's stopband: -52.8 dB at low, -34.0 at mid against -38);
    # the JAX harness is given the same equalization, on its spectral filter
    from ska_pst_dsp_tpu.design.fir import deripple_response as jax_deripple
    from ska_pst_dsp_tpu.utils import geometry as jax_geometry

    plain = jax_matrix.polyphase_synthesis
    n_chan = jax_load_config("low").channels

    def group_deripple(x, L, os_f, *, spans_nyquist=True, deripple_coeff=None,
                       spectral_filter=None, input_overlap=None, **kw):
        per = x.shape[1]
        if not spans_nyquist and deripple_coeff is not None:
            fnw = jax_geometry.SynthesisGeometry(per, L, input_overlap, os_f).fn_width
            dr = np.tile(jax_deripple(deripple_coeff, n_chan, fnw // 2), per).astype(np.float32)
            hr, hi = spectral_filter or (np.ones_like(dr), np.zeros_like(dr))
            spectral_filter, deripple_coeff = (hr * dr, hi * dr), None
        return plain(x, L, os_f, spans_nyquist=spans_nyquist, deripple_coeff=deripple_coeff,
                     spectral_filter=spectral_filter, input_overlap=input_overlap, **kw)

    monkeypatch.setattr(jax_matrix, "polyphase_synthesis", group_deripple)
    ref = jax_matrix.run_matrix(jax_load_config("low"))
    got = verify_dspsr_pfb_inversion.run_matrix(load_config("low"), device="cpu")
    assert list(got) == list(ref) and len(got) == 12
    for name, r in ref.items():
        g = got[name]
        assert g["ok"] == r["ok"] is True and g["shared_with"] == r["shared_with"]
        for key in ("mean_diff_db", "max_diff_db"):
            _same_db(g[key], r[key])


def test_matrix_mid_group_deripple(jax_noise):
    # SKA-Mid's 256-channel groups with deripple, at two inversion blocks of
    # the mid stream: during and after agree as without deripple
    cases = [c for c in verify_dspsr_pfb_inversion.CASES
             if c[1] and c[3] and not c[2]]  # multi channel, after, deripple
    got = verify_dspsr_pfb_inversion.run_matrix(load_config("mid"), n_bins=448 * 4096 * 2,
                                                cases=cases, device="cpu")
    (r,) = got.values()
    assert r["ok"] and r["mean_diff_db"] < -80


def test_matrix_cli_drift(products, jax_noise, monkeypatch):
    # the drift baseline is the port's own previous report for the device
    # type, never the JAX package's
    seen = []
    monkeypatch.setattr(verify_dspsr_pfb_inversion, "run_case",
                        lambda *a, **k: seen.append(k) or {"mean_diff_db": -45.0,
                                                           "max_diff_db": -30.0})
    (products / "jax" / "report.verify_pfb_inversion.json").write_text("{}")
    assert verify_dspsr_pfb_inversion.run(["-c", "low", "--device", "cpu"]) == 0
    path = products / "port" / "report.verify_pfb_inversion.cpu.json"
    first = json.loads(path.read_text())
    assert len(first) == 12 and len(seen) == 6
    assert all("baseline_mean_diff_db" not in r for r in first.values())
    assert verify_dspsr_pfb_inversion.run(["-c", "low", "--device", "cpu"]) == 0
    second = json.loads(path.read_text())
    assert all(r["baseline_mean_diff_db"] == -45.0 and r["drift_db"] == 0.0
               for r in second.values())


# ---------------------------------------------------------------------------
# defaults and imports
# ---------------------------------------------------------------------------

ENTRY_POINTS = [
    (purity.TestPurity.__init__, "device"),
    (test_backends.compare_channelizer_backends, "device"),
    (test_cross_implementation.run_suite, "device"),
    (test_cross_implementation._compare_inversions, "device"),
    (test_dedispersion.run_dedispersion_test, "device"),
    (verify_dspsr_pfb_inversion.run_matrix, "device"),
    (verify_dspsr_pfb_inversion._simulated_pulsar, "device"),
    (process_test_vectors.generate_tree, "device"),
    (process_test_vectors.process_test_vectors, "device"),
]


@pytest.mark.parametrize("fn,arg", ENTRY_POINTS, ids=[f.__qualname__ for f, _ in ENTRY_POINTS])
def test_device_defaults_to_the_card(fn, arg):
    assert inspect.signature(fn).parameters[arg].default == "cuda"


def test_cli_devices_default_to_the_card(products, monkeypatch):
    # each CLI hands its harness "cuda" unless given --device
    seen = []

    def record(report):
        def harness(*args, **kwargs):
            seen.append(kwargs["device"])
            return report
        return harness

    for mod, name, report in (
            (test_backends, "compare_channelizer_backends", {"mean_close": 1.0}),
            (test_cross_implementation, "run_suite", {}),
            (test_dedispersion, "run_dedispersion_test", {"mean_diff_db": -60.0}),
            (verify_dspsr_pfb_inversion, "run_matrix", {}),
            (process_test_vectors, "process_test_vectors", {"time": [], "freq": []})):
        monkeypatch.setattr(mod, name, record(report))
        if mod is not process_test_vectors:
            assert mod.run(["-c", "low"]) == 0
    process_test_vectors.run(["-c", "low", "-b", str(products)])
    assert seen == ["cuda"] * 5


def test_default_reports_are_named_by_device(products, monkeypatch):
    # each CLI's report is the JAX report's name with the device type
    # before .json; none is a committed product's name
    committed = set(os.listdir(REPO / "products"))
    monkeypatch.setattr(test_backends, "compare_channelizer_backends",
                        lambda *a, **k: {"mean_close": 1.0})
    monkeypatch.setattr(test_cross_implementation, "run_suite", lambda *a, **k: {})
    monkeypatch.setattr(test_dedispersion, "run_dedispersion_test",
                        lambda *a, **k: {"mean_diff_db": -60.0})
    monkeypatch.setattr(verify_dspsr_pfb_inversion, "run_matrix", lambda *a, **k: {})
    for device in ("cuda", "cpu", "cuda:0"):
        tag = torch.device(device).type
        for mod in (test_backends, test_cross_implementation, test_dedispersion,
                    verify_dspsr_pfb_inversion):
            assert mod.run(["-c", "low", "--device", device]) == 0
        # no sweep flag: the harness is built (nothing runs) and its empty
        # report written
        path = purity.run(["-c", "low", "--device", device])
        assert path.endswith(f".{tag}.json")
        written = sorted(os.listdir(products / "port"))
        assert all(f.endswith((".cpu.json", ".cuda.json")) for f in written)
        assert not committed & set(written)
        assert len([f for f in written if f.endswith(f".{tag}.json")]) == 5


def test_verify_imports_no_jax():
    """Importing every module of the slice leaves jax, the JAX package and
    matplotlib out of sys.modules (the card's machine has none of them)."""
    mods = ["verify", "verify.common", "verify.comparator", "verify.util", "verify.purity",
            "verify.test_backends", "verify.test_cross_implementation",
            "verify.test_dedispersion", "verify.verify_dspsr_pfb_inversion",
            "analysis", "analysis.compare_dump_files", "analysis.quicklook",
            "analysis.process_test_vectors"]
    code = ("import sys, json, runpy\n"
            + "".join(f"import ska_pst_dsp_tpu_torch.{m}\n" for m in mods)
            + "sys.path.insert(0, 'tools')\nimport purity_cuda, dedispersion_cuda\n"
            + "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'ska_pst_dsp_tpu', 'matplotlib'))))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
