"""The port's zero-padded (SKA-Mid) analysis and mid round trip, on the CPU.

* The composed ``polyphase_analysis_padded`` against the JAX one (1e-5 *
  scale, tests/test_pallas.py:268).
* A reduced mid slice — 1024 channels, OS 8/7, L=512 / overlap 128, so
  N = 458752 = 7*128*512 and both the fused channel DFT (plan (8, 128)) and
  the out-of-core epilogue (plan (7, 128, 512)) apply — through
  ``PaddedPFBRoundTrip`` (the kernels' plain versions on a CPU tensor)
  against the JAX fused chain in Pallas interpret mode and the JAX composed
  chain, at 1.2e-5 * scale; its analysis half against the JAX fused padded
  analysis at 1e-5 * scale.
* The padded state bit for bit against the JAX helpers, and the production
  mid module's geometry and dispatch.
"""

import numpy as np
import pytest
import torch

from ska_pst_dsp_tpu.design import fir
from ska_pst_dsp_tpu.utils import geometry, windows
from ska_pst_dsp_tpu.utils.rational import Rational
from ska_pst_dsp_tpu_torch.convert import padded_round_trip_state
from ska_pst_dsp_tpu_torch.entry import mid_round_trip
from ska_pst_dsp_tpu_torch.models import PaddedPFBRoundTrip
from ska_pst_dsp_tpu_torch.ops.analysis import polyphase_analysis_padded
from ska_pst_dsp_tpu_torch.ops.kernels import synthesis_fused as tsf
from ska_pst_dsp_tpu_torch.ops.kernels.analysis_padded_fused import (
    polyphase_analysis_padded_fused,
)
from ska_pst_dsp_tpu_torch.ops.kernels.ifft_big import plan_big_ifft

PADDED_TOL = 1e-5
TOL = 1.2e-5
OS = Rational(8, 7)
N_CHAN, L, OV = 1024, 512, 128
GEOM = geometry.SynthesisGeometry(N_CHAN, L, OV, OS)
STEP = geometry.analysis_step(N_CHAN, OS)
N_DAT = (2 * OV + GEOM.input_keep) * STEP  # 512 spectra -> one inversion block


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


@pytest.fixture(scope="module")
def filt():
    return fir.design_pfb_fir_filter(N_CHAN, OS, 4)


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(35)
    return (rng.standard_normal((2, N_DAT)).astype(np.float32),
            rng.standard_normal((2, N_DAT)).astype(np.float32))


@pytest.fixture(scope="module")
def model(filt):
    return PaddedPFBRoundTrip.from_filter(filt, N_CHAN, OS, L, OV, device="cpu")


@pytest.fixture(scope="module")
def port_out(model, stream):
    return model(torch.complex(*map(torch.as_tensor, stream))).numpy()


@pytest.fixture(scope="module")
def jax_fused(filt, stream):
    """The JAX fused chain of bench.py's mid leg, in Pallas interpret mode:
    (time-major channels, inverted stream)."""
    from ska_pst_dsp_tpu.ops.pallas.analysis_padded_fused import (
        polyphase_analysis_padded_fused as jax_analysis,
    )
    from ska_pst_dsp_tpu.ops.pallas.synthesis_fused import polyphase_synthesis_fused

    cr, ci = jax_analysis(stream, filt, N_CHAN, OS, time_major=True, interpret=True)
    rr, ri = polyphase_synthesis_fused(
        (cr, ci), L, OS, input_overlap=OV, deripple_coeff=filt,
        temporal_taper="tukey", time_major_in=True, interpret=True,
    )
    return (np.asarray(cr) + 1j * np.asarray(ci),
            np.asarray(rr) + 1j * np.asarray(ri))


class TestPaddedAnalysis:
    @pytest.mark.parametrize("block,os_f", [(512, Rational(4, 3)), (1024, Rational(8, 7))])
    @pytest.mark.parametrize("block0", [0, 5])
    @pytest.mark.parametrize("apply_delay", [True, False])
    def test_matches_jax_composed(self, block, os_f, block0, apply_delay):
        from ska_pst_dsp_tpu.ops import polyphase_analysis_padded as jax_padded

        f = fir.design_pfb_fir_filter(block, os_f, 4)
        x = _noise((2, 40_000), 36)
        kw = dict(block0=block0, apply_delay=apply_delay)
        ref = np.asarray(jax_padded(x, f, block, os_f, **kw))
        got = polyphase_analysis_padded(x, f, block, os_f, **kw).numpy()
        assert _rel_err(got, ref) < PADDED_TOL

    def test_pair_in_pair_out(self, filt):
        from ska_pst_dsp_tpu.ops import polyphase_analysis_padded as jax_padded

        x = _noise((1, 1, 30_000), 37)
        pair = (np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))
        jr, ji = jax_padded(pair, filt, N_CHAN, OS)
        gr, gi = polyphase_analysis_padded(
            tuple(map(torch.as_tensor, pair)), filt, N_CHAN, OS)
        assert gr.shape == (1, N_CHAN, 30_000 // STEP)
        assert _rel_err(gr.numpy() + 1j * gi.numpy(),
                        np.asarray(jr) + 1j * np.asarray(ji)) < PADDED_TOL

    def test_fused_chain_matches_jax_fused(self, filt, stream, jax_fused):
        # padded_fold + chan_dft_core (the kernels' plain versions) against
        # the Pallas fold + channel DFT; d = 8 runs its aligned fold there
        pair = tuple(map(torch.as_tensor, stream))
        gr, gi = polyphase_analysis_padded_fused(pair, filt, N_CHAN, OS, time_major=True)
        assert gr.shape == (2, N_DAT // STEP, N_CHAN)
        assert _rel_err(gr.numpy() + 1j * gi.numpy(), jax_fused[0]) < PADDED_TOL

    def test_fused_matches_composed_channel_major(self, filt):
        x = _noise((2, 20_000), 38)
        got = polyphase_analysis_padded_fused(x, filt, N_CHAN, OS, block0=3).numpy()
        ref = polyphase_analysis_padded(x, filt, N_CHAN, OS, block0=3).numpy()
        assert _rel_err(got, ref) < PADDED_TOL


class TestReducedMidSlice:
    def test_plans_apply(self):
        n, lo = GEOM.output_fft_length, GEOM.output_overlap
        assert (n, lo) == (458_752, 114_688)
        assert plan_big_ifft(n, lo) == (7, 128, 512)

    def test_matches_jax_fused_chain(self, port_out, jax_fused):
        assert _rel_err(port_out, jax_fused[1]) < TOL

    def test_matches_jax_composed_chain(self, filt, stream, port_out):
        from ska_pst_dsp_tpu.ops import polyphase_analysis_padded as jax_padded
        from ska_pst_dsp_tpu.ops import polyphase_synthesis

        cr, ci = jax_padded(stream, filt, N_CHAN, OS)
        rr, ri = polyphase_synthesis((cr, ci), L, OS, input_overlap=OV,
                                     deripple_coeff=filt, temporal_taper="tukey")
        assert _rel_err(port_out, np.asarray(rr) + 1j * np.asarray(ri)) < TOL

    def test_output_geometry(self, port_out):
        assert port_out.shape == (2, 1, GEOM.output_keep)
        assert np.isfinite(port_out).all()

    def test_reference_is_the_cpu_forward(self, model, stream, port_out):
        x = torch.complex(*map(torch.as_tensor, stream))
        np.testing.assert_array_equal(model.reference(x).numpy(), port_out)

    def test_dispatch_takes_the_out_of_core_epilogue(self, model, stream, monkeypatch):
        # the JAX order: small plan (none here), then the big plan, the pair
        # called with its one key (n, 1, p*q, n1, ...)
        keys = []
        real = tsf.fused_big_ifft_oc

        def spy(flat, elem=None, *, shape_key):
            keys.append(shape_key)
            return real(flat, elem, shape_key=shape_key)

        monkeypatch.setattr(tsf, "fused_big_ifft_oc", spy)
        model(torch.complex(*map(torch.as_tensor, stream)))
        assert keys == [(458_752, 1, 7 * 128, 512, 114_688, 224, 7 / 8)]


class TestPaddedState:
    def test_matches_jax_helpers_bitwise(self, filt):
        from ska_pst_dsp_tpu.design.fir import deripple_response
        from ska_pst_dsp_tpu.ops.analysis import _phase_ramp, _prep_filter

        state = padded_round_trip_state(filt, N_CHAN, OS, L, OV)
        np.testing.assert_array_equal(state["f2d_rev"], _prep_filter(filt, N_CHAN, reverse=True))
        # the constant of _padded_fused_core (analysis_padded_fused.py:306-312)
        rr, ri = _phase_ramp(N_CHAN, STEP, 8, 0)
        q = np.arange(N_CHAN)
        pr = (N_CHAN * np.cos(-2.0 * np.pi * q / N_CHAN)).astype(np.float64)
        pi_ = (N_CHAN * np.sin(-2.0 * np.pi * q / N_CHAN)).astype(np.float64)
        cr = rr.astype(np.float64) * pr - ri.astype(np.float64) * pi_
        ci = rr.astype(np.float64) * pi_ + ri.astype(np.float64) * pr
        np.testing.assert_array_equal(state["chan_const"].real, cr.astype(np.float32))
        np.testing.assert_array_equal(state["chan_const"].imag, ci.astype(np.float32))
        assert state["chan_const"].dtype == np.complex64
        assert state["delay"] == geometry.padded_sample_delay_shift(filt.size, N_CHAN, OS)
        np.testing.assert_array_equal(state["t_taper"], windows.build("tukey", L, OV))
        np.testing.assert_array_equal(
            state["dr"], deripple_response(filt, N_CHAN, GEOM.fn_width // 2).astype(np.float32))
        assert state["elem"] is None and "f2d" not in state and "ramp" not in state

    def test_load_state_buffers(self, model):
        names = {n for n, _ in model.named_buffers()}
        assert names == {"f2d_rev", "chan_const", "t_taper", "dr", "perm"}
        assert model.chan_const.shape == (8, N_CHAN) and model.delay == 3
        with pytest.raises(ValueError, match="channel count"):
            PaddedPFBRoundTrip(512, OS, L, OV).load_state(
                padded_round_trip_state(fir.design_pfb_fir_filter(N_CHAN, OS, 4),
                                        N_CHAN, OS, L, OV), "cpu")


def test_mid_round_trip_production_geometry():
    m = mid_round_trip("cpu")
    g = m.geom
    assert (m.n_chan, m.step, m.delay) == (4096, 3584, 14)
    assert m.f2d_rev.shape == (25, 4096) and m.chan_const.shape == (8, 4096)
    assert (g.fn_width, g.output_fft_length, g.output_overlap) == (448, 1_835_008, 458_752)
    assert plan_big_ifft(g.output_fft_length, g.output_overlap) == (7, 512, 512)
    # bench.py's mid input: 4,587,520 samples a pol -> 1280 spectra, 4 blocks
    assert (2 * 128 + 4 * g.input_keep) * m.step == 4_587_520
    assert g.n_blocks(4_587_520 // m.step) == 4
