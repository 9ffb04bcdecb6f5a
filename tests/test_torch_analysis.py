"""The port's analysis tools (ska_pst_dsp_tpu_torch.analysis) and the
on-card purity and dedispersion tools (tools/purity_cuda.py,
tools/dedispersion_cuda.py) against the JAX package's, on the CPU.

process_test_vectors, quicklook and compare_dump_files get the checks of
tests/test_process_test_vectors.py, on the port: the tree's inversions (the
``torch`` backend, plain versions on the CPU) within 1.2e-5 x scale of the
JAX package's tree from the same vectors, the independent (fp64 oracle)
inversion within 1e-5, the comparison reports equal. The tools' kernel
chains run on the CPU as their plain versions here: purity_cuda's forward
within 1.2e-5 x scale of the JAX package's one-shot pipeline, and
dedispersion_cuda's round trip with its gate and its whole-stream figures
within 0.5 dB of the JAX package's composed chain on the same samples. On
the CPU the tools refuse to run as a product, and their reports never take
a committed product's name.

param_opt's five studies run at shortened sweeps on the CPU against the JAX
package's studies: the inverted streams within 1.2e-5 x scale at each
study's geometry, every dB figure above -100 dB within 0.1 dB (linear
differences compared in dB). scaling_bench's comm_model gives the JAX
model's byte counts, and its CLI runs worlds 1 and 2 on the CPU;
entry.dryrun_multichip runs at world 2 over gloo on the CPU at the JAX
dryrun's stream sizes, every case inside its gate.
"""

import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ska_pst_dsp_tpu.analysis import compare_dump_files as jax_cdf
from ska_pst_dsp_tpu.analysis import param_opt as jax_param_opt
from ska_pst_dsp_tpu.analysis import process_test_vectors as jax_ptv
from ska_pst_dsp_tpu.cli import current_performance as jax_cp
from ska_pst_dsp_tpu.cli import scaling_bench as jax_scaling
from ska_pst_dsp_tpu.models import signals as jax_signals
from ska_pst_dsp_tpu.utils.config import load_config as jax_load_config
from ska_pst_dsp_tpu_torch.analysis import compare_dump_files as cdf
from ska_pst_dsp_tpu_torch.analysis import param_opt
from ska_pst_dsp_tpu_torch.analysis import process_test_vectors as ptv
from ska_pst_dsp_tpu_torch.analysis import quicklook
from ska_pst_dsp_tpu_torch.cli import scaling_bench
from ska_pst_dsp_tpu_torch.data_gen.generate_test_vector import (
    complex_sinusoid, time_domain_impulse,
)
from ska_pst_dsp_tpu_torch.design import fir
from ska_pst_dsp_tpu_torch.entry import dryrun_multichip
from ska_pst_dsp_tpu_torch.io import dada
from ska_pst_dsp_tpu_torch.models import signals
from ska_pst_dsp_tpu_torch.utils.config import load_config
from ska_pst_dsp_tpu_torch.utils.rational import Rational
from ska_pst_dsp_tpu_torch.verify.util import dB

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import dedispersion_cuda  # noqa: E402
import purity_cuda  # noqa: E402

SYNTHESIS_TOL = 1.2e-5
DB_TOL = 0.5


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.size > 0
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The port's test-vector tree (torch on the CPU) and the JAX package's
    from the same parameters, two impulses and two tones each."""
    base = tmp_path_factory.mktemp("tv_trees")
    cfg = load_config("low")
    cfg.load_fir_filter_coeff()
    assert ptv.generate_tree(cfg, str(base / "port"), n_test=2, device="cpu") == 4
    assert jax_ptv.generate_tree(jax_load_config("low"), str(base / "jax"), n_test=2) == 4
    return base


def test_iter_test_vectors(trees):
    found = list(ptv.iter_test_vectors(str(trees / "port")))
    assert len(found) == 4 and {d for d, _ in found} == {"time", "freq"}
    ref = list(jax_ptv.iter_test_vectors(str(trees / "jax")))
    assert [(d, os.path.basename(s)) for d, s in found] == [
        (d, os.path.basename(s)) for d, s in ref]
    for _, sub in found:
        with open(os.path.join(sub, "meta.json")) as f:
            meta = json.load(f)
        assert meta["config"] == "low"
        for key in ("input_file", "channelized_file", "inverted_file"):
            assert os.path.exists(os.path.join(sub, meta[key]))


def test_tree_inversions_match_jax(trees):
    for (_, sub), (_, jsub) in zip(ptv.iter_test_vectors(str(trees / "port")),
                                   jax_ptv.iter_test_vectors(str(trees / "jax"))):
        files = []
        for d in (sub, jsub):
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
            files.append([dada.DADAFile(os.path.join(d, meta[k])).load_data().data
                          for k in ("input_file", "inverted_file")])
        (inp, inv), (jinp, jinv) = files
        np.testing.assert_array_equal(inp, jinp)
        assert _rel(inv, jinv) <= SYNTHESIS_TOL


def test_three_way_report(trees, tmp_path, monkeypatch):
    monkeypatch.setattr(ptv, "products_dir", str(tmp_path))
    report = ptv.process_test_vectors(str(trees / "port"), plot=False, device="cpu")
    assert len(report["time"]) == 2 and len(report["freq"]) == 2
    for rows in report.values():
        for r in rows:
            # model inversion and the independent (fp64 oracle) inversion
            # agree far more tightly than either matches the input
            d = r["time_mean_diff"]
            assert d["independent_vs_inverted"] < 1e-5
            assert d["independent_vs_inverted"] < max(d["inverted_vs_input"], 1e-9)
    assert os.listdir(tmp_path) == ["report.process_test_vectors.cpu.json"]


def test_process_cli(trees, tmp_path, monkeypatch):
    monkeypatch.setattr(ptv, "products_dir", str(tmp_path))
    assert ptv.run(["-c", "low", "-b", str(trees / "port"), "--no-plot",
                    "--device", "cpu"]) == 0
    assert ptv.run(["-c", "low", "-b", str(tmp_path / "empty"), "--generate", "-n", "1",
                    "--no-plot", "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["empty", "report.process_test_vectors.cpu.json"]


def test_compare_dump_files_as_jax(trees, tmp_path):
    _, sub = next(ptv.iter_test_vectors(str(trees / "port")))
    with open(os.path.join(sub, "meta.json")) as f:
        meta = json.load(f)
    files = [os.path.join(sub, meta[k]) for k in ("input_file", "inverted_file")]
    reports = []
    for name, mod in (("port", cdf), ("jax", jax_cdf)):
        out = str(tmp_path / f"{name}.json")
        assert mod.run([*files, "--start", "1000", "--ndat", "8192", "--fft-size", "4096",
                        "--report", out]) == 0
        with open(out) as f:
            reports.append(json.load(f))
    assert reports[0] == reports[1]
    assert set(reports[0]["time"]) == {"diff_0_1", "diff_1_0", "this_0", "this_1"}
    raw = tmp_path / "x.bin"
    (np.arange(64) + 1j * np.arange(64)).astype(np.complex64).tofile(str(raw))
    np.testing.assert_array_equal(cdf.load_any(str(raw)), jax_cdf.load_any(str(raw)))


def test_quicklook_dada(trees, tmp_path):
    pytest.importorskip("matplotlib")
    _, sub = next(ptv.iter_test_vectors(str(trees / "port")))
    with open(os.path.join(sub, "meta.json")) as f:
        meta = json.load(f)
    for key in ("channelized_file", "input_file"):  # waterfall, then trace
        out = str(tmp_path / f"{key}.png")
        assert quicklook.plot_dada_file(os.path.join(sub, meta[key]), out_path=out) == out
        assert os.path.getsize(out) > 1000


def test_quicklook_binary(tmp_path):
    pytest.importorskip("matplotlib")
    raw = tmp_path / "x.bin"
    (np.arange(64) + 1j * np.arange(64)).astype(np.complex64).tofile(str(raw))
    npy = tmp_path / "y.npy"
    np.save(str(npy), np.arange(32, dtype=np.float32))
    for src, dtype in ((raw, "complex64"), (npy, "float32")):
        out = str(tmp_path / f"{src.name}.png")
        assert quicklook.run(["binary", "-i", str(src), "-dt", dtype, "-o", out]) == 0
        assert os.path.getsize(out) > 1000
    with pytest.raises(RuntimeError, match="data type"):
        quicklook.plot_binary_files(str(raw))


# ---------------------------------------------------------------------------
# tools/purity_cuda.py and tools/dedispersion_cuda.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["impulse", "tone"])
def test_purity_cuda_chain(kind):
    cfg, jcfg = load_config("low"), jax_load_config("low")
    n = cfg.os_factor.normalize(cfg.input_fft_length) * cfg.channels * cfg.blocks
    sig = (time_domain_impulse(n, [70001], [1]) if kind == "impulse"
           else complex_sinusoid(n, [3 * 37], [np.pi / 4]))
    _, ref, _ = jax_cp.test_data_pipeline(jcfg, sig, backend="jax")
    got = purity_cuda.fused_pipeline(cfg, cfg.load_fir_filter_coeff(), device="cpu")(sig)
    assert _rel(got, ref) <= SYNTHESIS_TOL


def test_purity_cuda_offsets_as_jax():
    sys.path.insert(0, str(REPO / "tools"))
    import purity_tpu

    for arr, n in ((np.arange(40), 16), (np.arange(5), 16), (np.arange(100), 7)):
        np.testing.assert_array_equal(purity_cuda.subsample(arr, n),
                                      purity_tpu.subsample(arr, n))


def _jax_dedispersion_reference():
    """tools/dedispersion_tpu.py's measurement on the JAX package's composed
    chain on the CPU (the tool itself runs on a TPU only)."""
    from ska_pst_dsp_tpu.ops import dedispersion as jd
    from ska_pst_dsp_tpu.ops import polyphase_analysis, polyphase_synthesis
    from ska_pst_dsp_tpu.utils import geometry

    cfg = jax_load_config("low")
    dm, f0, bw = 1.5, 1405.0, 40.0
    filt = cfg.load_fir_filter_coeff()
    g = geometry.SynthesisGeometry(cfg.channels, cfg.input_fft_length, cfg.input_overlap,
                                   cfg.os_factor)
    n = g.fn_width * cfg.channels * cfg.blocks * 2
    clean = np.asarray(jax_signals.SquareWave(period=4096, duty_cycle=0.1, on_amp=4.0,
                                              off_amp=0.04, seed=11).generate(0, n))[0, 0]
    x = jd.dedisperse(clean[None], dm, f0, bw, inverse=True)[0].astype(np.complex64)
    chan = polyphase_analysis(x[None, None], filt, cfg.channels, cfg.os_factor)
    kw = dict(input_overlap=cfg.input_overlap, deripple_coeff=filt,
              temporal_taper=cfg.temporal_taper)
    h = jd.chirp_filter(cfg.channels * g.fn_width, dm, f0, bw)
    b = np.asarray(polyphase_synthesis(chan, cfg.input_fft_length, cfg.os_factor,
                                       spectral_filter=h, **kw))[0, 0]
    plain = np.asarray(polyphase_synthesis(chan, cfg.input_fft_length, cfg.os_factor,
                                           **kw))[0, 0]
    a = np.asarray(jd.dedisperse(plain[None], dm, f0, bw))[0]
    m = min(a.size, b.size)
    guard = m // 8
    d = np.abs(b[guard: m - guard] - a[guard: m - guard]) ** 2
    r = np.abs(a[guard: m - guard]) ** 2
    return 10 * np.log10(d.mean() / r.mean()), 10 * np.log10(d.max() / r.max())


def test_dedispersion_cuda_round_trip(monkeypatch):
    def tiles(seed, stream, start, n, device):
        x = jax_signals._tiled_noise(jax.random.key(seed), start, n)
        return torch.as_tensor(np.asarray(x), device=device)

    monkeypatch.setattr(signals, "_tiled_noise", tiles)
    got = dedispersion_cuda.round_trip("cpu")
    assert got["fused_vs_composed_max_rel"] < 1e-4
    mean_db, max_db = _jax_dedispersion_reference()
    assert abs(got["blockwise_vs_wholestream_mean_db"] - mean_db) <= DB_TOL
    assert abs(got["blockwise_vs_wholestream_max_db"] - max_db) <= DB_TOL


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal of a machine without CUDA")
def test_tools_refuse_without_a_card(tmp_path):
    for argv in (["-c", "low", "--out", str(tmp_path / "p.json")],
                 ["-c", "mid", "-n", "2", "--out", str(tmp_path / "p.json")]):
        with pytest.raises(SystemExit, match="CUDA card only"):
            purity_cuda.main(argv)
    with pytest.raises(SystemExit, match="CUDA card only"):
        dedispersion_cuda.main(["--out", str(tmp_path / "d.json")])
    assert os.listdir(tmp_path) == []


def test_tool_reports_not_committed_names():
    committed = set(os.listdir(REPO / "products"))
    names = {f"report.purity.cuda.{c}.json" for c in ("low", "mid")}
    names.add("report.dedispersion.cuda.json")
    assert not names & committed
    import inspect

    assert "report.purity.cuda." in inspect.getsource(purity_cuda.main)
    assert "report.dedispersion.cuda.json" in inspect.getsource(dedispersion_cuda.main)


# --- param_opt, scaling_bench, dryrun_multichip ----------------------------

#: each study at a shortened sweep (the same arguments to both packages)
STUDY_ARGS = {
    "deripple": dict(taps_per_chan=(6, 12)),
    "overlap": dict(overlaps=(0, 16, 40)),
    "phase": dict(phases=np.linspace(0, 2 * np.pi, 3)),
    "search": dict(fft_lengths=(512,), overlaps=(128,), npoints=4),
    "pipeline": dict(nblocks=40),
}
#: record keys in dB, and the linear differences compared in dB
DB_KEYS = {"max_spurious", "total_spurious", "mean_spurious", "diff_max", "diff_sum",
           "diff_mean"}
LINEAR_KEYS = {"mean_diff", "max_diff"}
STUDY_DB_TOL = 0.1


@pytest.mark.parametrize("study", list(STUDY_ARGS))
def test_param_opt_study_matches_jax(study):
    """Each study on the CPU gives the JAX study's records: the swept
    parameters equal, each figure above -100 dB within 0.1 dB."""
    kw = STUDY_ARGS[study]
    got = param_opt.STUDIES[study](device="cpu", **kw)
    ref = jax_param_opt.STUDIES[study](**kw)
    assert got and len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k, v in r.items():
            if k in DB_KEYS or k in LINEAR_KEYS:
                a, b = (float(dB(x)) if k in LINEAR_KEYS else x for x in (g[k], v))
                if b > -100.0:
                    assert abs(a - b) <= STUDY_DB_TOL, (study, k, a, b)
            else:
                assert g[k] == v, (study, k)


@pytest.mark.parametrize("n_chan, os_f, L, ov, tpc, deripple", [
    (64, "4/3", 128, 24, 12, True),     # derippling, overlap, phase studies
    (64, "4/3", 128, 24, 6, False),
    (8, "8/7", 128, 0, 10, True),       # the pipeline study
    (256, "4/3", 512, 128, 12, True),   # the search
])
def test_param_opt_round_trip_matches_jax(n_chan, os_f, L, ov, tpc, deripple):
    """The studies' round trip (the composed ops) on the CPU: the inverted
    stream within 1.2e-5 x scale of the JAX study's, the aligned input the
    same."""
    filt = fir.design_pfb_fir_filter(n_chan, Rational.coerce(os_f), tpc)
    block = Rational.coerce(os_f).normalize(L) * n_chan
    sig = complex_sinusoid(block * 4, [0.23], [np.pi / 4], dtype=np.complex64)
    inp, inv = param_opt.round_trip(sig, filt, n_chan, Rational.coerce(os_f), L, ov, deripple,
                                    device="cpu")
    jinp, jinv = jax_param_opt._roundtrip(sig, filt, n_chan,
                                          jax_param_opt.Rational.coerce(os_f), L, ov, deripple)
    np.testing.assert_array_equal(inp, jinp)
    assert _rel(inv, jinv) <= SYNTHESIS_TOL


def test_param_opt_report_names():
    """The report carries the device type: never a committed product's
    name."""
    committed = set(os.listdir(REPO / "products"))
    for study in param_opt.STUDIES:
        for device in ("cpu", "cuda"):
            name = os.path.basename(param_opt.report_path(study, device))
            assert name.endswith(f".{device}.json") and name not in committed


def test_param_opt_cli(tmp_path, monkeypatch):
    monkeypatch.setattr(param_opt, "products_dir", str(tmp_path))
    assert param_opt.run(["--study", "phase", "--device", "cpu"]) == 0
    with open(tmp_path / "param_opt.phase.cpu.json") as f:
        assert len(json.load(f)) == 9


@pytest.mark.parametrize("geometry", [
    (256, 3073, 256, 48, "4/3"), (4096, 100353, 512, 128, "8/7"),
])
@pytest.mark.parametrize("dc", [2, 4])
def test_comm_model_bytes_as_jax(geometry, dc):
    """scaling_bench's comm_model gives the JAX model's byte counts, and
    at the JAX model's 45 GB/s its modelled seconds."""
    n_chan, taps, L, ov, os_f = geometry
    got = scaling_bench.comm_model(n_chan, taps, L, ov, Rational.coerce(os_f), dc=dc,
                                   link_gbs=45.0)
    ref = jax_scaling.comm_model(n_chan, taps, L, ov, jax_param_opt.Rational.coerce(os_f),
                                 dc=dc)
    for k in ("shard_raw_samples", "out_samples_per_shard_step", "halo_analysis_bytes",
              "halo_synthesis_bytes", "all_to_all_bytes_2d", "bytes_per_Msample_1d",
              "bytes_per_Msample_2d", "modeled_comm_seconds_per_Gsample_2d"):
        assert got[k] == ref[k], k
    assert got["link_gbs"] == 45.0 and "ici_gbs_assumed" not in got


def test_scaling_bench_cpu(tmp_path):
    """The CLI on the CPU at worlds 1 and 2: the exchanges each world
    issued, gloo, nothing staged, no Msamples/s (ranks share the CPU)."""
    assert scaling_bench.run(["--world", "1", "2", "--device", "cpu", "--reps", "1",
                              "--samples-per-rank", str(192 * 4 * 120),
                              "--products", str(tmp_path)]) == 0
    with open(tmp_path / "report.scaling.cpu.json") as f:
        rep = json.load(f)
    one, two = rep["runs"]["1"], rep["runs"]["2"]
    assert one["1d"]["collectives"] == {"none": {"calls": 0, "bytes": 0, "staged_bytes": 0}}
    assert two["backend"] == "gloo" and two["staged"] is False
    assert two["1d"]["collectives"]["halo"]["calls"] == 4
    assert two["2d_2xT"]["collectives"]["all_to_all"]["calls"] == 2
    assert "msps" not in two["1d"] and rep["comm_model"]["low"]["link_gbs"] == 450.0


def test_dryrun_multichip_world2_cpu():
    """The twin of __graft_entry__.dryrun_multichip at world 2 over gloo on
    the CPU, at the JAX dryrun's stream sizes: every case within its gate
    (tone mean error < 1e-3; two-stage chains < 1e-4 relative to the
    one-shot models)."""
    rep = dryrun_multichip(2, device="cpu")
    assert list(rep) == ["low-1d", "low-2d-dc2", "low-low-combine16", "sps-lowpsi", "mid-1d",
                         "mid-2d", "mid-prod"]
    for name, case in rep.items():
        assert case["error"] < case["gate"], name
        assert len(case["results"]) == 2
        assert all(r["backend"] == "gloo" for r in case["results"])
