"""The port's composed ops (ska_pst_dsp_tpu_torch.ops) against the JAX
package's composed functions, on the same numpy inputs, on the CPU.

Tolerances are those of tests/test_pallas.py: 8e-6 * scale for analysis,
1.2e-5 * scale for synthesis (fp32 FFTs in two libraries; measured
agreement is ~2e-7 * scale, so the bounds carry a wide margin).
"""

import numpy as np
import pytest
import torch

from ska_pst_dsp_tpu.design import fir
from ska_pst_dsp_tpu.ops import cfft as jcfft
from ska_pst_dsp_tpu.ops import framing as jframing
from ska_pst_dsp_tpu.ops import polyphase_analysis as jax_analysis
from ska_pst_dsp_tpu.ops import polyphase_synthesis as jax_synthesis
from ska_pst_dsp_tpu.ops.synthesis import (
    combine_channel_permutation as jax_perm,
)
from ska_pst_dsp_tpu.utils.rational import Rational
from ska_pst_dsp_tpu_torch.ops import cfft, framing
from ska_pst_dsp_tpu_torch.ops import polyphase_analysis, polyphase_synthesis
from ska_pst_dsp_tpu_torch.ops.synthesis import combine_channel_permutation

OS = Rational(4, 3)
N_CHAN, L, OV = 256, 256, 48
ANALYSIS_TOL = 8e-6
SYNTHESIS_TOL = 1.2e-5


@pytest.fixture(scope="module")
def filt():
    return fir.design_pfb_fir_filter(N_CHAN, OS, 12)


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


def _close(got, ref, tol):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol * scale


class TestCfft:
    def test_fft_ifft_match_jax(self):
        x = _noise((3, 96), 0)
        jr, ji = jcfft.fft(*jcfft.split(x))
        _close(cfft.fft(torch.as_tensor(x)).numpy(),
               np.asarray(jr) + 1j * np.asarray(ji), 1e-6)
        jr, ji = jcfft.ifft(*jcfft.split(x))
        _close(cfft.ifft(torch.as_tensor(x)).numpy(),
               np.asarray(jr) + 1j * np.asarray(ji), 1e-6)

    def test_pair_in_pair_out(self):
        x = _noise((2, 64), 1)
        yr, yi = cfft.fft(cfft.split(torch.as_tensor(x)))
        assert yr.dtype == torch.float32 and yi.dtype == torch.float32
        _close(yr.numpy() + 1j * yi.numpy(), np.fft.fft(x), 1e-6)
        pr, pi = cfft.cmul(cfft.split(torch.as_tensor(x)), cfft.split(torch.as_tensor(x)))
        _close(pr.numpy() + 1j * pi.numpy(), x * x, 1e-6)

    def test_fftshift_split_combine(self):
        x = _noise((4, 10), 2)
        got = cfft.fftshift(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcfft.fftshift(x)))
        xr, xi = cfft.split(x)
        np.testing.assert_array_equal(cfft.combine(xr, xi).numpy(), x)
        rr, ri = cfft.split(np.ones(5, np.float32))
        assert float(ri.abs().max()) == 0.0 and rr.shape == (5,)


class TestFraming:
    def test_matches_jax_frames_and_is_a_view(self):
        x = np.arange(2 * 100, dtype=np.float32).reshape(2, 100)
        t = torch.as_tensor(x)
        got = framing.frame(t, 12, 5, 15)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jframing.frame(x, 12, 5, 15)))
        assert got.data_ptr() == t.data_ptr()

    @pytest.mark.parametrize("n_frames", [0, 30])
    def test_same_errors_as_jax(self, n_frames):
        x = np.zeros((1, 100), np.float32)
        with pytest.raises(ValueError):
            jframing.frame(x, 12, 5, n_frames)
        with pytest.raises(ValueError):
            framing.frame(torch.as_tensor(x), 12, 5, n_frames)


class TestAnalysis:
    @pytest.mark.parametrize("block0", [0, 5])
    def test_matches_jax(self, filt, block0):
        x = _noise((2, 60_000), 3)
        ref = np.asarray(jax_analysis(x, filt, N_CHAN, OS, block0=block0))
        got = polyphase_analysis(x, filt, N_CHAN, OS, block0=block0).numpy()
        _close(got, ref, ANALYSIS_TOL)

    def test_pair_api_and_small_geometry(self):
        n = np.arange(8 * 32 + 1) - 4 * 32
        coeff = np.sinc(n / 32) * np.hamming(n.size)
        x = _noise((1, 1, 5000), 4)
        pair = (np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))
        jr, ji = jax_analysis(pair, coeff, 32, "32/27")
        gr, gi = polyphase_analysis(
            (torch.as_tensor(pair[0]), torch.as_tensor(pair[1])), coeff, 32, "32/27"
        )
        _close(gr.numpy() + 1j * gi.numpy(), np.asarray(jr) + 1j * np.asarray(ji),
               ANALYSIS_TOL)


SYNTHESIS_CASES = {
    "default": {},
    "spectral_taper": {"spectral_taper": "tukey"},
    "spectral_filter": {"spectral_filter": np.exp(
        2j * np.pi * np.random.default_rng(5).random(N_CHAN * 192)
    ).astype(np.complex64)},
    "combine16": {"combine": 16},
    "no_nyquist": {"spans_nyquist": False},
}


class TestSynthesis:
    @pytest.mark.parametrize("case", sorted(SYNTHESIS_CASES))
    def test_matches_jax(self, filt, case):
        kwargs = SYNTHESIS_CASES[case]
        x = _noise((2, N_CHAN, 1200), 6)
        common = dict(input_overlap=OV, deripple_coeff=filt,
                      temporal_taper="tukey", **kwargs)
        ref = np.asarray(jax_synthesis(x, L, OS, **common))
        got = polyphase_synthesis(x, L, OS, **common).numpy()
        _close(got, ref, SYNTHESIS_TOL)

    def test_sample_offset_monotonic_pair(self):
        x = _noise((1, 8, 400), 7)
        pair = (np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))
        kw = dict(input_overlap=8, sample_offset=3, monotonic=True, combine=4)
        jr, ji = jax_synthesis(pair, 64, OS, **kw)
        gr, gi = polyphase_synthesis(
            (torch.as_tensor(pair[0]), torch.as_tensor(pair[1])), 64, OS, **kw
        )
        _close(gr.numpy() + 1j * gi.numpy(), np.asarray(jr) + 1j * np.asarray(ji),
               SYNTHESIS_TOL)

    def test_rejects_bad_spectral_filter(self):
        with pytest.raises(ValueError, match="spectral_filter"):
            polyphase_synthesis(_noise((1, 8, 400), 8), 64, OS, input_overlap=8,
                                spectral_filter=np.ones(7, np.complex64))

    @pytest.mark.parametrize("n_chan,combine", [(256, 1), (256, 16), (64, 4)])
    def test_permutation_matches_jax(self, n_chan, combine):
        np.testing.assert_array_equal(
            combine_channel_permutation(n_chan, combine), jax_perm(n_chan, combine)
        )
