"""The port's LowCBF firmware filterbank, its heap I/O and dedispersion,
against the JAX package on the CPU.

``polyphase_analysis_lowcbf`` runs on the analysis kernel with the LowCBF
quarter-turn table in place of the derotation ramp; on a CPU tensor that is
the kernel's plain version (``analysis_core``) plus the kept-bin gather,
held here to the JAX function and the fp64 oracle at 2e-6 * scale
(tests/test_analysis.py:36) and to a direct transcription of the JAX core.
The port's own LowCBF oracle (``oracle.pst_filterbank`` and
``oracle.polyphase_analysis_lowcbf``) is held to the JAX oracle within
1e-12 * scale, and the CPU route to it at 2e-6.
The heap reshape and the DADA files are held to JAX's byte for byte; the
chirp phase bit for bit, ``dedisperse`` at 2e-5, and the inversion
commutes with dedispersion as in tests/test_verify.py:168-198.
"""

import numpy as np
import pytest
import torch

from ska_pst_dsp_tpu import oracle as jax_oracle
from ska_pst_dsp_tpu.io import dada as jax_dada
from ska_pst_dsp_tpu.io import lowcbf as jax_io_lowcbf
from ska_pst_dsp_tpu.ops import dedispersion as jax_dd
from ska_pst_dsp_tpu.ops import lowcbf as jax_lowcbf
from ska_pst_dsp_tpu.ops import polyphase_synthesis as jax_synthesis
from ska_pst_dsp_tpu.utils.rational import Rational as JaxRational
from ska_pst_dsp_tpu_torch import oracle
from ska_pst_dsp_tpu_torch.design import fir
from ska_pst_dsp_tpu_torch.io import dada
from ska_pst_dsp_tpu_torch.io import lowcbf as io_lowcbf
from ska_pst_dsp_tpu_torch.ops import dedispersion as dd
from ska_pst_dsp_tpu_torch.ops import lowcbf
from ska_pst_dsp_tpu_torch.ops.analysis import analysis_core, ramp_period
from ska_pst_dsp_tpu_torch.ops.kernels import analysis_fused as af
from ska_pst_dsp_tpu_torch.ops.analysis import polyphase_analysis
from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import polyphase_synthesis_fused
from ska_pst_dsp_tpu_torch.ops.synthesis import polyphase_synthesis
from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.rational import Rational

REL_TOL = 2e-6     # tests/test_analysis.py:36
SYNTHESIS_TOL = 1.2e-5
ORACLE_TOL = 1e-12  # the port's oracle against the JAX one (test_torch_host.py)


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _taps(seed):
    return np.random.default_rng(seed).standard_normal(3072)


def _raised(fn, *args, **kwargs):
    """The type of the exception fn raises; the test fails if it raises none."""
    with pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    return info.type


class TestAnalysis:
    @pytest.mark.parametrize("first_call,n_dat", [(True, 10_000), (False, 8_000)])
    def test_matches_jax_and_oracle(self, first_call, n_dat):
        taps = np.random.default_rng(7).standard_normal(3072)
        x = _noise((2, 1, n_dat), 8)
        got = lowcbf.polyphase_analysis_lowcbf(x, taps, first_call=first_call).numpy()
        ref = jax_oracle.polyphase_analysis_lowcbf(
            x.astype(np.complex128), taps, 256, JaxRational(4, 3), first_call=first_call)
        assert _rel_err(got, ref) < REL_TOL
        jax_out = np.asarray(jax_lowcbf.polyphase_analysis_lowcbf(x, taps, first_call=first_call))
        assert _rel_err(got, jax_out) < REL_TOL

    def test_ramp_route_equals_composed_core(self):
        # the kernel's route (analysis_core with the LowCBF table, then the
        # kept-bin gather) against a transcription of the JAX core
        # (lowcbf.py:51-68: fold, FFT, fftshift, quarter turns, keep, scale)
        taps = np.random.default_rng(9).standard_normal(3072)
        x = torch.as_tensor(_noise((2, 5000), 10))
        f2d = torch.as_tensor(lowcbf.lowcbf_filter(taps))
        n_out = (x.shape[1] - 3072) // 192
        frames = x.unfold(-1, 3072, 192)[:, :n_out].reshape(2, n_out, 12, 256)
        spec = torch.fft.fftshift(torch.fft.fft((frames * f2d).sum(-2)), dim=-1)
        rot = torch.as_tensor(lowcbf._rotation_table())[torch.arange(n_out) % 4]
        ref = (spec * rot)[..., 20:236] * lowcbf.SCALE
        got = analysis_core(x, f2d, torch.as_tensor(lowcbf.lowcbf_ramp()), 192).index_select(
            -1, torch.as_tensor(lowcbf.kept_bins()))
        assert _rel_err(got.numpy(), ref.numpy()) < 1e-6

    def test_tables(self):
        ramp = lowcbf.lowcbf_ramp()
        assert ramp.shape == (4, 256) and ramp.dtype == np.complex64
        assert ramp_period(256, 192) == 4 and af.takes(256, 192, 12, 4)
        rr, ri = jax_lowcbf._rotation_table()
        shifted = (np.arange(256) + 128) % 256
        np.testing.assert_array_equal(ramp, (rr + 1j * ri)[:, shifted] * np.float32(16))
        np.testing.assert_array_equal(lowcbf.kept_bins()[[0, 107, 108, 215]], [148, 255, 0, 107])
        for name in ("NFILT", "BLOCK", "STEP", "TAPS", "KEPT_LO", "KEPT", "FIRST_CALL_PAD"):
            assert getattr(lowcbf, name) == getattr(jax_lowcbf, name)

    def test_kinds_and_shape(self):
        taps = np.ones(3072)
        x = _noise((2, 3072 + 192 * 10), 11)
        out = lowcbf.polyphase_analysis_lowcbf(x, taps, first_call=False)
        assert out.shape == (2, 216, 10) and out.dtype == torch.complex64
        re, im = lowcbf.polyphase_analysis_lowcbf(
            (torch.as_tensor(x.real), torch.as_tensor(x.imag)), taps, first_call=False)
        assert torch.equal(torch.complex(re, im), out)


class TestOracle:
    @pytest.mark.parametrize("do_padding,n_dat", [(True, 4001), (False, 5003)])
    def test_pst_filterbank_matches_jax(self, do_padding, n_dat):
        din = _noise((n_dat,), 20).astype(np.complex128)
        got = oracle.pst_filterbank(din, _taps(21), do_padding)
        ref = jax_oracle.pst_filterbank(din, _taps(21), do_padding)
        assert got.shape == ref.shape == (216, (n_dat + 1536 * do_padding - 3072) // 192)
        assert got.dtype == ref.dtype == np.complex128
        assert _rel_err(got, ref) <= ORACLE_TOL

    # 1919 + 1536 and 3265 samples give exactly one spectrum: the last full
    # window is never emitted (no +1 in the count)
    @pytest.mark.parametrize("first_call,n_pol,n_dat", [(True, 2, 9001), (False, 1, 7777),
                                                         (True, 1, 1919), (False, 2, 3265)])
    def test_analysis_lowcbf_matches_jax(self, first_call, n_pol, n_dat):
        x = _noise((n_pol, 1, n_dat), 22).astype(np.complex128)
        got = oracle.polyphase_analysis_lowcbf(x, _taps(23), 256, Rational(4, 3),
                                               first_call=first_call)
        ref = jax_oracle.polyphase_analysis_lowcbf(x, _taps(23), 256, JaxRational(4, 3),
                                                   first_call=first_call)
        n_out = (n_dat + 1536 * first_call - 3072) // 192
        assert got.shape == ref.shape == (n_pol, 216, n_out) and n_out >= 1
        assert got.dtype == ref.dtype == np.complex128
        assert _rel_err(got, ref) <= ORACLE_TOL

    def test_dtype_follows_the_input(self):
        x = _noise((1, 1, 4000), 24)
        got = oracle.polyphase_analysis_lowcbf(x, _taps(25), 256, Rational(4, 3))
        assert got.dtype == np.complex64 == jax_oracle.polyphase_analysis_lowcbf(
            x, _taps(25), 256, JaxRational(4, 3)).dtype

    @pytest.mark.parametrize("first_call,n_dat", [(True, 1000), (False, 3000)])
    def test_short_input_raises_as_jax(self, first_call, n_dat):
        # shorter than one window less the padding: a negative spectrum
        # count, which both oracles refuse in np.zeros
        x = _noise((1, 1, n_dat), 26).astype(np.complex128)
        kinds = {_raised(mod.polyphase_analysis_lowcbf, x, _taps(27), 256, None,
                         first_call=first_call) for mod in (oracle, jax_oracle)}
        kinds |= {_raised(mod.pst_filterbank, x[0, 0], _taps(27), first_call)
                  for mod in (oracle, jax_oracle)}
        assert kinds == {ValueError}

    @pytest.mark.parametrize("first_call,n_dat", [(True, 10_001), (False, 8_191)])
    def test_route_matches_port_oracle(self, first_call, n_dat):
        # the CPU route (the kernel's plain version) against the port's own
        # fp64 oracle, as the card's route is held in chip_smoke.py
        taps = _taps(28)
        x = _noise((2, 1, n_dat), 29)
        got = lowcbf.polyphase_analysis_lowcbf(x, taps, first_call=first_call).numpy()
        ref = oracle.polyphase_analysis_lowcbf(x.astype(np.complex128), taps, 256,
                                               Rational(4, 3), first_call=first_call)
        assert ref.dtype == np.complex128
        assert _rel_err(got, ref) < REL_TOL


class TestHeaps:
    @pytest.mark.parametrize("n_pol,n_chan,n_dat", [(2, 4, 320), (1, 3, 100), (2, 216, 64)])
    def test_reshape_bitwise(self, n_pol, n_chan, n_dat):
        data = _noise((n_pol, n_chan, n_dat), 12)
        flat = io_lowcbf.flatten_low_cbf_stream(data)
        np.testing.assert_array_equal(flat, jax_io_lowcbf.flatten_low_cbf_stream(data))
        np.testing.assert_array_equal(io_lowcbf.reshape_low_cbf_stream(flat, n_pol, n_chan),
                                      jax_io_lowcbf.reshape_low_cbf_stream(flat, n_pol, n_chan))
        hdr = {"NPOL": str(n_pol), "NCHAN": str(n_chan)}
        pft = flat.reshape(-1, n_chan, n_pol).transpose(2, 1, 0)
        np.testing.assert_array_equal(io_lowcbf.reshape_low_cbf_data(pft, hdr),
                                      jax_io_lowcbf.reshape_low_cbf_data(pft, hdr))

    def test_file_read_both_ways(self, tmp_path):
        # the port's LowCBF writer gives the file the JAX package's own
        # tests write by hand (tests/test_native.py:53-67), byte for byte;
        # both readers return the data, whole or in windows of whole heaps
        data = _noise((2, 4, 320), 13)
        path = str(tmp_path / "port.dada")
        dada.save_lowcbf(path, data, {"HDR_SIZE": "4096"})
        flat = jax_io_lowcbf.flatten_low_cbf_stream(data)
        hdr = {"INSTRUMENT": "LowCBF", "NPOL": "2", "NCHAN": "4", "NBIT": "32", "NDIM": "2"}
        ref_path = tmp_path / "jax.dada"
        with open(ref_path, "wb") as f:
            f.write(jax_dada.serialize_header({**hdr, "HDR_SIZE": "4096"}))
            words = np.empty(flat.size * 2, np.float32)
            words[0::2], words[1::2] = flat.real, flat.imag
            words.tofile(f)
        assert (tmp_path / "port.dada").read_bytes() == ref_path.read_bytes()
        for kw in ({}, {"offset_samples": 64, "count": 96}, {"offset_samples": 288}):
            got, got_hdr = dada.load(path, **kw)
            ref, ref_hdr = jax_dada.load(path, **kw)
            np.testing.assert_array_equal(got, ref)
            assert got_hdr == ref_hdr
        np.testing.assert_array_equal(dada.load(path)[0], data)


class TestDedispersion:
    @pytest.mark.parametrize("n,dm,f0,bw", [(4096, 2.64, 1405.0, 40.0), (1001, 1.5, 300.0, 1.0),
                                            (1 << 16, 0.3, 1405.0, 40.0)])
    def test_chirp_bitwise(self, n, dm, f0, bw):
        np.testing.assert_array_equal(dd.chirp_phase(n, dm, f0, bw),
                                      jax_dd.chirp_phase(n, dm, f0, bw))
        for inverse in (False, True):
            re, im = dd.chirp_filter(n, dm, f0, bw, inverse, pair=True)
            jr, ji = jax_dd.chirp_filter(n, dm, f0, bw, inverse)
            np.testing.assert_array_equal(re, jr)
            np.testing.assert_array_equal(im, ji)
            h = dd.chirp_filter(n, dm, f0, bw, inverse)
            assert h.dtype == np.complex64 and np.array_equal(h, re + 1j * im)
        assert dd.KDM == jax_dd.KDM
        assert dd.dispersion_delay(dm, f0 - bw / 2, f0) == jax_dd.dispersion_delay(
            dm, f0 - bw / 2, f0)

    @pytest.mark.parametrize("inverse", [False, True])
    def test_dedisperse_matches_jax(self, inverse):
        x = _noise((2, 1 << 14), 14)
        got = dd.dedisperse(torch.as_tensor(x), 2.64, 1405.0, 40.0, inverse=inverse).numpy()
        ref = np.asarray(jax_dd.dedisperse(x, 2.64, 1405.0, 40.0, inverse=inverse))
        np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)
        back = dd.dedisperse(torch.as_tensor(got), 2.64, 1405.0, 40.0, inverse=not inverse)
        np.testing.assert_allclose(back.numpy(), x, atol=2e-5)

    def test_inversion_commutes_with_dedispersion(self):
        # tests/test_verify.py:168-198 on the port: dedisperse(invert(
        # channelize(x))) equals dedisperse(x) to the inversion's floor
        os_f = Rational(4, 3)
        n_chan, L, ov = 64, 128, 24
        filt = fir.design_pfb_fir_filter(n_chan, os_f, 12)
        n = 2 ** 16
        x = _noise((n,), 1)
        chan = polyphase_analysis(torch.as_tensor(x[None, None]), filt, n_chan, os_f)
        inv = polyphase_synthesis(chan, L, os_f, input_overlap=ov, deripple_coeff=filt,
                                  temporal_taper="tukey")[0, 0]
        shift = geometry.total_sample_shift(n_chan, os_f, filt.size, ov)
        m = (min(inv.shape[0], n - shift) // 2) * 2
        a = dd.dedisperse(inv[:m][None], 2.64, 1405.0, 40.0)[0]
        b = dd.dedisperse(torch.as_tensor(x[shift: shift + m][None]), 2.64, 1405.0, 40.0)[0]
        s = m // 8
        assert (a[s:-s] - b[s:-s]).abs().mean() < 1e-3

    def test_chirp_in_the_spectral_filter_slot(self):
        # the chirp riding the inversion's spectral_filter: the port's fused
        # drop-in (the epilogue's elem) against the JAX composed inversion
        os_f = Rational(4, 3)
        n_chan, L, ov = 64, 128, 24
        filt = fir.design_pfb_fir_filter(n_chan, os_f, 12)
        g = geometry.SynthesisGeometry(n_chan, L, ov, os_f)
        h = dd.chirp_filter(n_chan * g.fn_width, 0.5, 1405.0, 40.0)
        x = _noise((1, n_chan, 2 * ov + 3 * g.input_keep), 15)
        kw = dict(input_overlap=ov, deripple_coeff=filt, temporal_taper="tukey")
        got = polyphase_synthesis_fused(x, L, os_f, spectral_filter=h, **kw).numpy()
        ref = np.asarray(jax_synthesis(x, L, JaxRational(4, 3), spectral_filter=(h.real, h.imag),
                                       **kw))
        assert _rel_err(got, ref) < SYNTHESIS_TOL
