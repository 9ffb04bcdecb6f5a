"""The port's orchestration layer against the JAX package's: DADA files,
test vectors, the testbench conversion, file-level channelize and
synthesize, pipeline and dispose, and the stage timer and trace.

The same inputs go through both packages on the CPU (the port's drop-ins
run their plain versions there): files written from the same array and
header are the same bytes; channelized files agree within 8e-6 x scale
(1e-5 for the padded analysis) and synthesized ones within 1.2e-5 x scale,
the tolerances of tests/test_pallas.py, with identical headers.
"""

import json
import os

import numpy as np
import pytest
import torch

import ska_pst_dsp_tpu.ops as jax_ops
from ska_pst_dsp_tpu import data_gen as jax_dg
from ska_pst_dsp_tpu.io import dada as jax_dada
from ska_pst_dsp_tpu.io import testbench as jax_testbench
from ska_pst_dsp_tpu_torch import data_gen as dg
from ska_pst_dsp_tpu_torch import ops
from ska_pst_dsp_tpu_torch.data_gen import util as dg_util
from ska_pst_dsp_tpu_torch.design import fir
from ska_pst_dsp_tpu_torch.io import dada, testbench
from ska_pst_dsp_tpu_torch.utils import profiling
from ska_pst_dsp_tpu_torch.utils.rational import Rational

ANALYSIS_TOL = 8e-6
PADDED_TOL = 1e-5
SYNTHESIS_TOL = 1.2e-5
#: 3 inversion blocks of the low geometry (tests/test_sgcht_matrix.py's size)
LOW_N = 3 * 131072
HEADER = {"HDR_VERSION": "1.0", "TSAMP": "0.025", "UTC_START": "2019-02-05-01:15:49",
          "SOURCE": "test", "OBS_OFFSET": "0"}


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_ops_exports_match():
    def public(mod):
        return sorted(n for n in vars(mod) if not n.startswith("_")
                      and callable(getattr(mod, n)))
    assert public(ops) == public(jax_ops)
    assert {"polyphase_analysis", "polyphase_analysis_padded", "polyphase_analysis_lowcbf",
            "polyphase_synthesis"} <= set(public(ops))


# ---------------------------------------------------------------------------
# DADA bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbit", [None, 8, 16])
def test_save_and_append_same_bytes(tmp_path, nbit):
    a, b = 40 * _noise((2, 3, 50), 1), 40 * _noise((2, 3, 30), 2)
    paths = []
    for name, mod in (("jax", jax_dada), ("port", dada)):
        p = str(tmp_path / f"{name}.dada")
        mod.save(p, a, HEADER, nbit=nbit)
        mod.append(p, b)
        paths.append(p)
    assert _bytes(paths[0]) == _bytes(paths[1])
    data, header = dada.load(paths[0])
    assert data.shape == (2, 3, 80) and header["NBIT"] == str(nbit or 32)


def test_append_refusals(tmp_path):
    p = str(tmp_path / "x.dada")
    dada.save(p, _noise((1, 1, 8), 3), HEADER)
    with pytest.raises(ValueError, match="complexity"):
        dada.append(p, np.ones((1, 1, 8), np.float32))
    with pytest.raises(ValueError, match="dtype"):
        dada.append(p, _noise((1, 1, 8), 3).astype(np.complex128))


def test_dadafile_same_bytes(tmp_path):
    x = _noise((5, 2, 3), 4)  # (T, F, P)
    paths = []
    for name, mod in (("jax", jax_dada), ("port", dada)):
        f = mod.DADAFile(str(tmp_path / name / "f.dada"))
        f.data = x
        f.header = dict(HEADER)
        f["NEW_KEY"] = 7
        paths.append(f.dump_data())
    assert _bytes(paths[0]) == _bytes(paths[1])
    g = dada.DADAFile(paths[0]).load_data()
    assert (g.ndat, g.nchan, g.npol) == (5, 2, 3) and "NEW_KEY" in g
    np.testing.assert_array_equal(g.data, x)
    np.testing.assert_array_equal(g.data_pft, x.transpose(2, 1, 0))


def test_fir_header_round_trip():
    h1, h2 = np.linspace(-1, 1, 17), np.hanning(9)
    osf = ["4/3", "32/27"]
    ours = dada.add_fir_filter_to_header(HEADER, [h1, h2], osf)
    assert ours == jax_dada.add_fir_filter_to_header(HEADER, [h1, h2], osf)
    back = dada.get_fir_filters_from_header(ours)
    ref = jax_dada.get_fir_filters_from_header(ours)
    assert [str(o) for _, o in back] == [str(o) for _, o in ref] == ["4/3", "32/27"]
    for (c, _), (r, _) in zip(back, ref):
        np.testing.assert_array_equal(c, r)
    np.testing.assert_allclose(back[0][0], h1, rtol=1e-6)


# ---------------------------------------------------------------------------
# files written on the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("domain,args", [
    ("freq", ([0.25], [np.pi / 4], 0.1)), ("time", ([0.5], [3])), ("noise", ([1.0],))])
def test_generate_test_vector_same_bytes(tmp_path, domain, args):
    files = []
    for name, mod in (("jax", jax_dg), ("port", dg)):
        gen = mod.generate_test_vector(backend="numpy", domain_name=domain, n_bins=4096)
        files.append(gen(*args, output_dir=str(tmp_path / name), n_pol=2))
    assert os.path.basename(files[0].file_path) == os.path.basename(files[1].file_path)
    assert _bytes(files[0].file_path) == _bytes(files[1].file_path)


def test_generate_test_vector_default_backend(tmp_path):
    f = dg.generate_test_vector(domain_name="freq", n_bins=64)([0.25], [0.0],
                                                               output_dir=str(tmp_path))
    assert f.file_path.endswith(".torch.dump")


def test_testbench_same_bytes(tmp_path):
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2 ** 32, size=4 * 2 * 6, dtype=np.uint64)
    hex_path = tmp_path / "tb.hex"
    hex_path.write_text("# testbench dump\n" + "".join(f"{w:08x}\n" for w in words) + "\n")
    outs = [mod.fb_tb_to_dada(str(hex_path), str(tmp_path / f"{name}.dada"), n_chan=4)
            for name, mod in (("jax", jax_testbench), ("port", testbench))]
    assert _bytes(outs[0]) == _bytes(outs[1])
    np.testing.assert_array_equal(testbench.load_fb_tb_data(str(hex_path), 4),
                                  jax_testbench.load_fb_tb_data(str(hex_path), 4))


# ---------------------------------------------------------------------------
# file-level numerics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def low_files(tmp_path_factory):
    """A two-polarization noise file of 3 x 131072 samples, channelized at
    low by each package, and JAX's channelized file synthesized by each."""
    d = tmp_path_factory.mktemp("low")
    src = str(d / "input.dada")
    dada.save(src, _noise((2, 1, LOW_N), 6), HEADER)
    chan = {name: mod.channelize(src, channels=256, os_factor_str="4/3",
                                 output_dir=str(d), output_file_name=f"chan.{name}.dump",
                                 **kw)
            for name, mod, kw in (("jax", jax_dg, {"backend": "jax"}),
                                  ("port", dg, {"backend": "torch", "device": "cpu"}))}
    synth = {name: mod.synthesize(chan["jax"].file_path, input_fft_length=256,
                                  input_overlap=48, output_dir=str(d),
                                  output_file_name=f"synth.{name}.dump", **kw)
             for name, mod, kw in (("jax", jax_dg, {"backend": "jax"}),
                                   ("port", dg, {"backend": "torch", "device": "cpu"}))}
    return chan, synth


def test_channelize_low(low_files):
    chan, _ = low_files
    got, ref = chan["port"], chan["jax"]
    assert got.header == ref.header
    assert got.data.shape == ref.data.shape and got.nchan == 256
    assert _rel(got.data, ref.data) <= ANALYSIS_TOL


def test_synthesize_low(low_files):
    _, synth = low_files
    got, ref = synth["port"], synth["jax"]
    assert got.header == ref.header and got.nchan == 1
    assert got.data.shape == ref.data.shape and got.ndat > 0
    assert _rel(got.data, ref.data) <= SYNTHESIS_TOL


def test_channelize_padded(tmp_path):
    """--use-padded at a small padded geometry (256 channels, OS 8/7, a
    1793-tap prototype: tests/test_current_performance.py's)."""
    filt_path = str(tmp_path / "filt.npy")
    np.save(filt_path, np.asarray(fir.design_pfb_fir_filter(256, Rational(8, 7), 7)))
    src = str(tmp_path / "input.dada")
    dada.save(src, _noise((1, 1, 60 * 224), 7), HEADER)
    out = [mod.channelize(src, channels=256, os_factor_str="8/7", fir_filter_path=filt_path,
                          use_padded=True, output_dir=str(tmp_path),
                          output_file_name=f"{name}.dump", **kw)
           for name, mod, kw in (("jax", jax_dg, {"backend": "jax"}),
                                 ("port", dg, {"backend": "torch", "device": "cpu"}))]
    assert out[1].header == out[0].header
    assert out[1].data.shape == out[0].data.shape
    assert _rel(out[1].data, out[0].data) <= PADDED_TOL


@pytest.mark.parametrize("backend", ["numpy", "matlab", "python"])
def test_numpy_backend_and_aliases(low_files, tmp_path, backend):
    """The oracle backend (and the reference's names for it) against the
    torch backend's file: 3e-6 x scale, the fp64 oracle tolerance of
    tests/test_synthesis.py:37."""
    chan, _ = low_files
    src = os.path.join(os.path.dirname(chan["port"].file_path), "input.dada")
    got = dg.channelize(src, channels=256, os_factor_str="4/3", backend=backend,
                        output_dir=str(tmp_path))
    assert got.header == chan["port"].header
    assert _rel(chan["port"].data, got.data) <= 3e-6


@pytest.mark.parametrize("fn", [dg.channelize, dg.synthesize])
def test_jax_backend_refused(fn, tmp_path):
    src = str(tmp_path / "x.dada")
    dada.save(src, _noise((1, 1, 64), 8), HEADER)
    with pytest.raises(ValueError, match="torch"):
        fn(src, backend="jax", output_dir=str(tmp_path))


@pytest.mark.parametrize("fn", [dg.channelize, dg.synthesize])
def test_default_device_is_the_card(fn):
    import inspect

    params = inspect.signature(fn.__wrapped__).parameters
    assert params["device"].default == "cuda" and params["backend"].default == "torch"


def test_resolve_backend():
    assert [dg_util.resolve_backend(b) for b in ("torch", "numpy", "matlab", "python")] == [
        "torch", "numpy", "numpy", "numpy"]
    with pytest.raises(ValueError, match="torch"):
        dg_util.resolve_backend("jax")


# ---------------------------------------------------------------------------
# pipeline and dispose
# ---------------------------------------------------------------------------

def _pipeline(mod, out_dir, **kw):
    pipe = mod.pipeline(
        mod.generate_test_vector(backend="numpy", domain_name="time", n_bins=3 * 192 * 64),
        mod.channelize(channels=64, os_factor_str="4/3", **kw),
        mod.synthesize(input_fft_length=128, input_overlap=24, **kw),
        output_dir=out_dir,
    )
    return pipe([0.5], [1])


@pytest.mark.parametrize("dispose_all", [False, True])
def test_pipeline_and_dispose(tmp_path, dispose_all):
    kept = {}
    for name, mod, kw in (("jax", jax_dg, {"backend": "jax"}),
                          ("port", dg, {"backend": "torch", "device": "cpu"})):
        out_dir = tmp_path / name
        files = _pipeline(mod, str(out_dir), **kw)
        assert [os.path.basename(f.file_path).split(".")[0] for f in files] == [
            "time_domain_impulse", "channelized", "synthesized"]
        before = sorted(os.listdir(out_dir))
        with mod.dispose(*files, dispose_all=dispose_all) as got:
            assert got == files
        kept[name] = (before, sorted(os.listdir(out_dir)), files)
    assert kept["port"][:2] == kept["jax"][:2]
    assert len(kept["port"][1]) == (0 if dispose_all else 1)
    assert [f.header for f in kept["port"][2]] == [f.header for f in kept["jax"][2]]


def test_dispose_keep(tmp_path):
    paths = [str(tmp_path / n) for n in ("a", "b")]
    for p in paths:
        open(p, "w").write("x")
    with dg.dispose(*paths, keep=True):
        pass
    assert all(os.path.exists(p) for p in paths)


# ---------------------------------------------------------------------------
# the stage timer and the trace
# ---------------------------------------------------------------------------

def test_stage_timer_report():
    t = profiling.StageTimer("cpu")
    for _ in range(3):
        with t.stage("read", samples=1000):
            pass
    with t.stage("write"):
        pass
    rep = t.report(log=lambda *a: None)
    assert sorted(rep) == ["read", "write"]
    assert t.items == {"read": 3000, "write": 0}
    assert set(rep["write"]) == {"seconds"} and rep["read"]["seconds"] >= 0
    assert t.device == torch.device("cpu")


def test_stage_timer_in_channelize(low_files, tmp_path):
    chan, _ = low_files
    src = os.path.join(os.path.dirname(chan["port"].file_path), "input.dada")
    t = profiling.StageTimer("cpu")
    dg.channelize(src, channels=256, os_factor_str="4/3", device="cpu", timer=t,
                  output_dir=str(tmp_path))
    assert sorted(t.seconds) == ["compute", "read", "write"]
    assert t.items["compute"] == 2 * LOW_N


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("SKA_PST_TRACE_DIR", raising=False)
    with profiling.trace():
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("SKA_PST_TRACE_DIR", str(tmp_path / "tr"))
    with profiling.trace():
        torch.fft.fft(torch.ones(64, dtype=torch.complex64))
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("fft" in e.get("name", "") for e in events)
