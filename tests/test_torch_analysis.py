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
from ska_pst_dsp_tpu.analysis import process_test_vectors as jax_ptv
from ska_pst_dsp_tpu.cli import current_performance as jax_cp
from ska_pst_dsp_tpu.models import signals as jax_signals
from ska_pst_dsp_tpu.utils.config import load_config as jax_load_config
from ska_pst_dsp_tpu_torch.analysis import compare_dump_files as cdf
from ska_pst_dsp_tpu_torch.analysis import process_test_vectors as ptv
from ska_pst_dsp_tpu_torch.analysis import quicklook
from ska_pst_dsp_tpu_torch.data_gen.generate_test_vector import (
    complex_sinusoid, time_domain_impulse,
)
from ska_pst_dsp_tpu_torch.io import dada
from ska_pst_dsp_tpu_torch.models import signals
from ska_pst_dsp_tpu_torch.utils.config import load_config

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
