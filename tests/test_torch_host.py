"""The port's own host modules against the JAX package's originals.

The port carries copies of the host code it needs (``utils``, ``design.fir``,
``oracle``, ``io.dada``, ``verify.util``) and imports nothing of
:mod:`ska_pst_dsp_tpu`. Here each copy is held to its original: FIR designs,
deripple vectors and windows bit for bit, geometry and configs equal, the
fp64 oracle within 1e-12 * scale, DADA files readable both ways and written
byte for byte alike, spurious-power scores equal. An AST scan of every
module of the port and of ``chip_smoke.py`` finds no import of the JAX
package, and another finds, for every public top-level name of every module
of the JAX package (and of the repository's ``bench.py``), its counterpart
in the port's module of the same path, but for the names in ``NOT_PORTED``.
"""

import ast
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

from ska_pst_dsp_tpu import oracle as jax_oracle
from ska_pst_dsp_tpu.design import fir as jax_fir
from ska_pst_dsp_tpu.io import dada as jax_dada
from ska_pst_dsp_tpu.utils import config as jax_config
from ska_pst_dsp_tpu.utils import geometry as jax_geometry
from ska_pst_dsp_tpu.utils import windows as jax_windows
from ska_pst_dsp_tpu.utils.rational import Rational as JaxRational
from ska_pst_dsp_tpu.verify import util as jax_util
from ska_pst_dsp_tpu_torch import oracle
from ska_pst_dsp_tpu_torch.design import fir
from ska_pst_dsp_tpu_torch.io import dada
from ska_pst_dsp_tpu_torch.utils import config, geometry, windows
from ska_pst_dsp_tpu_torch.utils.rational import Rational
from ska_pst_dsp_tpu_torch.verify import util

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "ska_pst_dsp_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    if "_build" not in p.parts
)
JAX = REPO / "ska_pst_dsp_tpu"
PORT = REPO / "ska_pst_dsp_tpu_torch"
JAX_FILES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))
#: modules of the JAX system outside its package, by their path in the
#: repository, and their counterparts' paths in the port
OUTSIDE = {"bench.py": "bench.py"}
SCANNED = JAX_FILES + sorted(OUTSIDE)
#: public names of the JAX package with no counterpart in the port, each
#: with its reason (ROADMAP.md, "Not to port"); "*" is every name of the
#: module, or the name in every module
_KARATSUBA = ("the TPU's real-matmul DFT (split-bf16 Karatsuba); the card has "
              "complex64 FFTs")
_V5E = "the v5e's peaks; the port keys its peaks on the card"
NOT_PORTED = {
    ("ops/cfft.py", "BASE"): _KARATSUBA,
    ("ops/cfft.py", "MODE"): "the SKA_PST_FFT_MODE switch of " + _KARATSUBA,
    ("ops/cfft.py", "kar_dot"): _KARATSUBA,
    ("ops/cfft.py", "karatsuba_consts"): _KARATSUBA,
    ("ops/cfft.py", "kernel_dot"): _KARATSUBA,
    ("ops/cfft.py", "split_bf16"): _KARATSUBA,
    ("bench.py", "V5E_BF16_TFLOPS"): _V5E,
    ("bench.py", "V5E_HBM_GBS"): _V5E,
    ("*", "Array"): "a type alias",
    ("*", "Pair"): "a type alias",
}
#: names of a Pallas kernel's tiling plan whose counterpart in the CUDA
#: kernel's module goes by another name
RENAMED = {
    ("ops/pallas/analysis_padded_fused.py", "phases_of"): "plan",
    ("ops/pallas/chan_dft_fused.py", "KB"): "POINTS",
    ("ops/pallas/chan_dft_fused.py", "plan_chan_dft"): "kernel_split",
}
ORACLE_TOL = 1e-12
LOW, MID = (256, Rational(4, 3)), (4096, Rational(8, 7))


def _jax_package_imports(path: Path):
    """Names of ska_pst_dsp_tpu modules that a source file imports."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [n for n in names
                  if n == "ska_pst_dsp_tpu" or n.startswith("ska_pst_dsp_tpu.")]
    return found


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_import_of_the_jax_package(rel):
    assert _jax_package_imports(REPO / rel) == []


def test_scan_sees_an_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nimport ska_pst_dsp_tpu.ops as o\n"
                   "def f():\n    from ska_pst_dsp_tpu import oracle\n"
                   "from ska_pst_dsp_tpu_torch.utils import geometry\n")
    assert _jax_package_imports(src) == ["ska_pst_dsp_tpu.ops", "ska_pst_dsp_tpu"]
    assert "chip_smoke.py" in PORT_FILES and len(PORT_FILES) > 20


def _public_names(path: Path):
    """Public names a module defines at its top level (defs, classes and
    assignments), read with ast."""
    found = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            found.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            found |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
    return {n for n in found if not n.startswith("_")}


def _jax_path(rel: str) -> Path:
    """A scanned module: a path of the JAX package, or of OUTSIDE."""
    return REPO / rel if rel in OUTSIDE else JAX / rel


def _port_path(rel: str, port: Path = PORT) -> Path:
    """The port's module of a scanned module's path: ops/pallas/<name>.py is
    ops/kernels/<name>.py; OUTSIDE maps the modules outside the package."""
    if rel in OUTSIDE:
        return port / OUTSIDE[rel]
    return port / rel.replace("ops/pallas/", "ops/kernels/", 1)


def _not_ported(rel: str, name: str) -> bool:
    return any(key in NOT_PORTED for key in ((rel, name), (rel, "*"), ("*", name)))


def _missing(rel: str, port: Path = PORT):
    """Public names of the JAX module ``rel`` with no counterpart in the
    port's module of the same path and not in NOT_PORTED."""
    theirs = _public_names(_jax_path(rel))
    target = _port_path(rel, port)
    ours = _public_names(target) if target.exists() else set()
    return sorted(n for n in theirs
                  if RENAMED.get((rel, n), n) not in ours and not _not_ported(rel, n))


@pytest.mark.parametrize("rel", SCANNED)
def test_every_jax_name_has_a_counterpart(rel):
    assert _missing(rel) == []


def test_not_ported_table_is_exact():
    # every exception names a module and a name of the JAX package that the
    # port lacks: none is stale, and nothing the port has hides behind one
    for (rel, name), reason in NOT_PORTED.items():
        assert reason
        rels = SCANNED if rel == "*" else [rel]
        hits = [r for r in rels
                if name == "*" or name in _public_names(_jax_path(r))]
        assert hits, (rel, name)
        for r in hits:
            target = _port_path(r)
            assert not target.exists() if name == "*" else name not in _public_names(target)
    for (rel, name), ours in RENAMED.items():
        assert name in _public_names(JAX / rel) and name not in _public_names(_port_path(rel))
        assert ours in _public_names(_port_path(rel))
    assert not any(name in ("pst_filterbank", "polyphase_analysis_lowcbf")
                   for _, name in NOT_PORTED)


def test_scan_sees_a_deleted_name(tmp_path):
    # a copy of the port with a def, an assignment and a whole module taken
    # away: the scan reports each, and nothing the exceptions cover
    port = tmp_path / "port"
    for rel in ("oracle.py", "ops/lowcbf.py", "ops/cfft.py"):
        (port / rel).parent.mkdir(parents=True, exist_ok=True)
        (port / rel).write_text((PORT / rel).read_text())
    src = (port / "oracle.py").read_text()
    (port / "oracle.py").write_text(src.replace("def pst_filterbank(", "def _gone("))
    src = (port / "ops/lowcbf.py").read_text()
    (port / "ops/lowcbf.py").write_text(src.replace("\nSTEP = 192", "\n_STEP = 192"))
    assert _missing("oracle.py", port=port) == ["pst_filterbank"]
    assert _missing("ops/lowcbf.py", port=port) == ["STEP"]
    assert _missing("ops/cfft.py", port=port) == []
    assert "chan_dft_ramp" in _missing("ops/pallas/chan_dft_fused.py", port=port)
    assert _missing("ops/pallas/chan_dft_fused.py") == []
    # bench.py is scanned against the port's bench module; the v5e peaks
    # are the exceptions
    assert _missing("bench.py", port=port) == ["CONFIGS", "bench_low", "bench_mid",
                                               "bench_oracle_cpu", "main"]
    assert _missing("bench.py") == []
    assert len(JAX_FILES) > 50 and "oracle.py" in JAX_FILES and "bench.py" in SCANNED


class TestDesign:
    def test_low_design_bitwise(self):
        got = fir.design_pfb_fir_filter(*LOW, 12)
        np.testing.assert_array_equal(got, jax_fir.design_pfb_fir_filter(256, JaxRational(4, 3), 12))
        assert got.size == 3073

    def test_mid_two_stage_design_bitwise(self):
        got = fir.design_pfb_fir_filter_two_stage(*MID)
        ref = jax_fir.design_pfb_fir_filter_two_stage(4096, JaxRational(8, 7))
        np.testing.assert_array_equal(got, ref)
        assert got.size == 100353

    @pytest.mark.parametrize("half", [96, 224])
    def test_deripple_response_bitwise(self, half):
        h = fir.design_pfb_fir_filter(*LOW, 12)
        np.testing.assert_array_equal(fir.deripple_response(h, 256, half),
                                      jax_fir.deripple_response(h, 256, half))

    def test_designers_table(self):
        assert list(fir._DESIGNERS) == list(jax_fir._DESIGNERS)

    @pytest.mark.parametrize("name", ["low", "mid"])
    def test_load_or_design_same_coefficients(self, name):
        cfg = config.load_config(name)
        np.testing.assert_array_equal(cfg.load_fir_filter_coeff(),
                                      jax_config.load_config(name).load_fir_filter_coeff())


class TestUtils:
    @pytest.mark.parametrize("name", jax_config.available_configs())
    def test_configs_equal(self, name):
        got = dataclasses.asdict(config.load_config(name))
        ref = dataclasses.asdict(jax_config.load_config(name))
        assert got.pop("os_factor") == ref.pop("os_factor")
        assert got == ref

    def test_config_dir_is_the_repos(self):
        assert config.CONFIG_DIR == jax_config.CONFIG_DIR == str(REPO / "config")
        assert os.path.exists(config.TEST_CONFIG_FILE)

    @pytest.mark.parametrize("chan,os_f,taps,L,ov", [(256, (4, 3), 3073, 256, 48),
                                                     (4096, (8, 7), 100353, 512, 128)])
    def test_geometry_equal(self, chan, os_f, taps, L, ov):
        r, jr = Rational(*os_f), JaxRational(*os_f)
        g = geometry.SynthesisGeometry(chan, L, ov, r)
        jg = jax_geometry.SynthesisGeometry(chan, L, ov, jr)
        for prop in ("input_keep", "output_fft_length", "output_overlap", "output_keep",
                     "fn_width", "discard"):
            assert getattr(g, prop) == getattr(jg, prop), prop
        for n_dat in (10_000, 4_587_520):
            assert g.n_blocks(n_dat) == jg.n_blocks(n_dat)
            assert g.output_ndat(n_dat) == jg.output_ndat(n_dat)
            assert (geometry.analysis_nblocks(n_dat, taps, chan, r)
                    == jax_geometry.analysis_nblocks(n_dat, taps, chan, jr))
            assert (geometry.calc_output_nbins(n_dat, chan, r, taps, L, ov)
                    == jax_geometry.calc_output_nbins(n_dat, chan, jr, taps, L, ov))
        assert geometry.padded_filter_length(taps, chan) == jax_geometry.padded_filter_length(taps, chan)
        assert geometry.analysis_step(chan, r) == jax_geometry.analysis_step(chan, jr)
        assert (geometry.padded_sample_delay_shift(taps, chan, r)
                == jax_geometry.padded_sample_delay_shift(taps, chan, jr))
        for padded in (False, True):
            assert (geometry.total_sample_shift(chan, r, taps, ov, padded=padded)
                    == jax_geometry.total_sample_shift(chan, jr, taps, ov, padded=padded))

    @pytest.mark.parametrize("name", sorted(jax_windows.WINDOW_REGISTRY))
    def test_windows_bitwise(self, name):
        assert sorted(windows.WINDOW_REGISTRY) == sorted(jax_windows.WINDOW_REGISTRY)
        for n, ov in ((256, 48), (512, 128), (1_835_008, 128)):
            got, ref = windows.build(name, n, ov), jax_windows.build(name, n, ov)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)

    def test_rational(self):
        r = Rational.coerce("8/7")
        assert (r.nu, r.de, str(r), float(r)) == (8, 7, "8/7", 8 / 7)
        assert r.normalize(512) == 448 and r.multiply(448) == 512
        assert Rational.coerce({"nu": 4, "de": 3}) == Rational(8, 6)
        assert Rational.coerce(JaxRational(8, 7)) == r  # tests hand JAX's to the port
        with pytest.raises(ValueError, match="not integral"):
            r.normalize(100)


def _oracle_input(n_dat, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 1, n_dat))
            + 1j * rng.standard_normal((2, 1, n_dat))).astype(np.complex128)


def _scaled_err(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    return np.abs(got - ref).max() / np.abs(ref).max()


class TestOracle:
    def test_analysis(self):
        filt = fir.design_pfb_fir_filter(16, Rational(4, 3), 4)
        x = _oracle_input(1200, 1)
        got = oracle.polyphase_analysis(x, filt, 16, Rational(4, 3))
        assert _scaled_err(got, jax_oracle.polyphase_analysis(x, filt, 16, JaxRational(4, 3))) <= ORACLE_TOL

    def test_padded_analysis(self):
        filt = fir.design_pfb_fir_filter(32, Rational(8, 7), 4)
        x = _oracle_input(1400, 2)
        got = oracle.polyphase_analysis_padded(x, filt, 32, Rational(8, 7))
        ref = jax_oracle.polyphase_analysis_padded(x, filt, 32, JaxRational(8, 7))
        assert _scaled_err(got, ref) <= ORACLE_TOL

    @pytest.mark.parametrize("deripple", [False, True])
    def test_synthesis(self, deripple):
        filt = fir.design_pfb_fir_filter(16, Rational(4, 3), 4)
        chan = oracle.polyphase_analysis(_oracle_input(6000, 3), filt, 16, Rational(4, 3))
        taper = windows.tukey_window(64, 8).astype(np.float64)
        kw = dict(input_overlap=8, deripple_coeff=filt if deripple else None,
                  temporal_taper=taper)
        got = oracle.polyphase_synthesis(chan, 64, Rational(4, 3), **kw)
        ref = jax_oracle.polyphase_synthesis(chan, 64, JaxRational(4, 3), **kw)
        assert _scaled_err(got, ref) <= ORACLE_TOL


_DADA_CASES = [(np.complex64, None), (np.complex128, None), (np.float32, None),
               (np.complex64, 8), (np.complex64, 16)]


def _dada_data(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 50)) * 40
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal((2, 3, 50)) * 40
    return x.astype(dtype)


class TestDada:
    @pytest.mark.parametrize("dtype,nbit", _DADA_CASES)
    def test_port_writes_jax_reads(self, tmp_path, dtype, nbit):
        data, hdr = _dada_data(dtype), {"TELESCOPE": "SKA", "FREQ": "1000"}
        path = str(tmp_path / "port.dada")
        dada.save(path, data, hdr, nbit=nbit)
        got, got_hdr = jax_dada.load(path)
        ref, ref_hdr = dada.load(path)
        np.testing.assert_array_equal(got, ref)
        assert got_hdr == ref_hdr and got_hdr["TELESCOPE"] == "SKA"
        if nbit is None:
            np.testing.assert_array_equal(got, data)

    @pytest.mark.parametrize("dtype,nbit", _DADA_CASES)
    def test_jax_writes_port_reads(self, tmp_path, dtype, nbit):
        data, hdr = _dada_data(dtype), {"TELESCOPE": "SKA", "HDR_SIZE": "4096"}
        path = str(tmp_path / "jax.dada")
        jax_dada.save(path, data, hdr, nbit=nbit)
        got, got_hdr = dada.load(path)
        ref, ref_hdr = jax_dada.load(path)
        np.testing.assert_array_equal(got, ref)
        assert got_hdr == ref_hdr

    def test_files_byte_identical(self, tmp_path):
        data = _dada_data(np.complex64)
        hdr = {f"KEY_{i}": "x" * 60 for i in range(80)}  # overflows 4096: HDR_SIZE doubles
        dada.save(str(tmp_path / "a.dada"), data, hdr)
        jax_dada.save(str(tmp_path / "b.dada"), data, hdr)
        a, b = (tmp_path / "a.dada").read_bytes(), (tmp_path / "b.dada").read_bytes()
        assert a == b and dada.read_header(str(tmp_path / "a.dada"))["HDR_SIZE"] == "8192"

    def test_windowed_load(self, tmp_path):
        data = _dada_data(np.complex64)
        path = str(tmp_path / "w.dada")
        dada.save(path, data, {})
        got, _ = dada.load(path, count=10, offset_samples=5)
        ref, _ = jax_dada.load(path, count=10, offset_samples=5)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, data[:, :, 5:15])

    def test_lowcbf_refused(self, tmp_path):
        # a LowCBF heap file is read in whole 32-sample heaps, as the JAX
        # package's split reader requires (io/dada.py:125-127); any other
        # window is refused
        path = str(tmp_path / "l.dada")
        dada.save(path, _dada_data(np.complex64), {"INSTRUMENT": "LowCBF"})
        for window in ({"offset_samples": 5}, {"count": 20}):
            with pytest.raises(ValueError, match="LowCBF"):
                dada.load(path, **window)
        np.testing.assert_array_equal(dada.load(path)[0], jax_dada.load(path)[0])


class TestSpurious:
    def test_domain_performance_equal(self):
        rng = np.random.default_rng(5)
        t = np.arange(4096)
        tone = np.exp(2j * np.pi * 37 * t / 4096) + 1e-4 * rng.standard_normal(4096)
        for guard in (1, 2):
            got, ref = util.DomainPerformance(guard), jax_util.DomainPerformance(guard)
            assert got.spectral_performance(tone) == ref.spectral_performance(tone)
            assert got.spectral_performance(tone, 2048) == ref.spectral_performance(tone, 2048)
            assert got.temporal_performance(tone) == ref.temporal_performance(tone)
            assert (got.temporal_difference(tone, tone[::-1])
                    == ref.temporal_difference(tone, tone[::-1]))

    def test_spurious_helpers_equal(self):
        a = np.random.default_rng(6).standard_normal(300)
        for name in ("total_spurious", "mean_spurious", "max_spurious"):
            assert getattr(util, name)(a) == getattr(jax_util, name)(a)
        np.testing.assert_array_equal(util.spurious(a), jax_util.spurious(a))
        np.testing.assert_array_equal(util.dB(a), jax_util.dB(a))
