"""The port's SKA-Low round trip as a whole, on the CPU.

PFBRoundTrip (the kernels' plain versions on a CPU tensor) against the JAX
package's fused chain in Pallas interpret mode — the chain bench.py times
on its chip — and against its composed chain, at 1.2e-5 * scale (the
synthesis tolerance of tests/test_pallas.py). The carried state is held to
the JAX helpers bit for bit, and the port must run without importing JAX.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ska_pst_dsp_tpu.design import fir
from ska_pst_dsp_tpu.utils import geometry, windows
from ska_pst_dsp_tpu.utils.rational import Rational
from ska_pst_dsp_tpu_torch.convert import round_trip_state
from ska_pst_dsp_tpu_torch.entry import entry, low_round_trip
from ska_pst_dsp_tpu_torch.models import PFBRoundTrip

OS = Rational(4, 3)
N_CHAN, L, OV = 256, 256, 48
N_DAT = 90_000  # 451 spectra -> 2 inversion blocks
TOL = 1.2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def filt():
    return fir.design_pfb_fir_filter(N_CHAN, OS, 12)


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(23)
    return (rng.standard_normal((2, N_DAT)).astype(np.float32),
            rng.standard_normal((2, N_DAT)).astype(np.float32))


@pytest.fixture(scope="module")
def port_out(stream):
    xr, xi = stream
    out = low_round_trip("cpu")(torch.complex(torch.as_tensor(xr), torch.as_tensor(xi)))
    return out.numpy()


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


class TestRoundTrip:
    def test_matches_jax_fused_chain(self, filt, stream, port_out):
        from ska_pst_dsp_tpu.ops.pallas.analysis_fused import polyphase_analysis_fused
        from ska_pst_dsp_tpu.ops.pallas.synthesis_fused import polyphase_synthesis_fused

        (cr, ci), nb = polyphase_analysis_fused(
            stream, filt, N_CHAN, OS, time_major=True, keep_padding=True,
            interpret=True,
        )
        rr, ri = polyphase_synthesis_fused(
            (cr, ci), L, OS, input_overlap=OV, deripple_coeff=filt,
            temporal_taper="tukey", time_major_in=True, valid_len=nb,
            interpret=True,
        )
        assert _rel_err(port_out, np.asarray(rr) + 1j * np.asarray(ri)) < TOL

    def test_matches_jax_composed_chain(self, filt, stream, port_out):
        from ska_pst_dsp_tpu.ops import polyphase_analysis, polyphase_synthesis

        cr, ci = polyphase_analysis(stream, filt, N_CHAN, OS)
        rr, ri = polyphase_synthesis((cr, ci), L, OS, input_overlap=OV,
                                     deripple_coeff=filt, temporal_taper="tukey")
        assert _rel_err(port_out, np.asarray(rr) + 1j * np.asarray(ri)) < TOL

    def test_output_geometry(self, filt, port_out):
        geom = geometry.SynthesisGeometry(N_CHAN, L, OV, OS)
        n_out = geom.output_ndat(geometry.analysis_nblocks(N_DAT, filt.size, N_CHAN, OS))
        assert port_out.shape == (2, 1, n_out) and n_out == 2 * geom.output_keep
        assert np.isfinite(port_out).all()

    def test_reference_is_the_cpu_forward(self, stream, port_out):
        model = low_round_trip("cpu")
        x = torch.complex(*map(torch.as_tensor, stream))
        np.testing.assert_array_equal(model.reference(x).numpy(), port_out)

    def test_entry(self):
        fn, (xr, xi) = entry("cpu")
        assert xr.shape == xi.shape == (2, 2**18) and xr.dtype == np.float32
        rr, ri = fn(xr, xi)
        assert rr.dtype == torch.float32 and rr.shape[:2] == (2, 1)
        assert np.isfinite(rr.numpy()).all() and np.isfinite(ri.numpy()).all()


class TestState:
    def test_matches_jax_helpers_bitwise(self, filt):
        from ska_pst_dsp_tpu.design.fir import deripple_response
        from ska_pst_dsp_tpu.ops.analysis import _phase_ramp, _prep_filter
        from ska_pst_dsp_tpu.ops.synthesis import combine_channel_permutation

        state = round_trip_state(filt, N_CHAN, OS, L, OV)
        step = geometry.analysis_step(N_CHAN, OS)
        rr, ri = _phase_ramp(N_CHAN, step, OS.nu, 0)
        np.testing.assert_array_equal(state["f2d"], _prep_filter(filt, N_CHAN))
        np.testing.assert_array_equal(state["ramp"].real, rr)
        np.testing.assert_array_equal(state["ramp"].imag, ri)
        np.testing.assert_array_equal(state["t_taper"], windows.build("tukey", L, OV))
        np.testing.assert_array_equal(
            state["dr"], deripple_response(filt, N_CHAN, 96).astype(np.float32))
        np.testing.assert_array_equal(
            state["perm"], combine_channel_permutation(N_CHAN, 1).astype(np.int32))
        assert state["elem"] is None
        assert state["perm"].dtype == np.int32 and state["f2d"].dtype == np.float32

    def test_elem_and_combine(self, filt):
        from ska_pst_dsp_tpu.ops.synthesis import combine_channel_permutation

        state = round_trip_state(filt, N_CHAN, OS, L, OV, spectral_taper="tukey",
                                 deripple=False, combine=16)
        s = windows.build("tukey", N_CHAN * 192, OV)
        np.testing.assert_array_equal(state["elem"].real, np.roll(s, 96))
        assert not state["elem"].imag.any()
        np.testing.assert_array_equal(state["dr"], np.ones(192, np.float32))
        np.testing.assert_array_equal(
            state["perm"], combine_channel_permutation(N_CHAN, 16).astype(np.int32))

    def test_load_state_buffers(self, filt):
        m = PFBRoundTrip.from_filter(filt, N_CHAN, OS, L, OV, device="cpu")
        names = {n for n, _ in m.named_buffers()}
        assert names == {"f2d", "ramp", "t_taper", "dr", "perm"}
        assert m.ramp.dtype == torch.complex64 and m.perm.dtype == torch.int32
        with pytest.raises(ValueError, match="channel count"):
            PFBRoundTrip(128, OS, L, OV).load_state(round_trip_state(filt, N_CHAN, OS, L, OV), "cpu")


def test_port_imports_no_jax():
    """Importing the port and running one CPU slice leaves jax and every
    module of the JAX package (ska_pst_dsp_tpu) out of sys.modules: the
    card's machine has no JAX, and the port carries its own host modules."""
    code = (
        "import sys, json, torch\n"
        "import ska_pst_dsp_tpu_torch\n"
        "from ska_pst_dsp_tpu_torch.entry import entry\n"
        "import ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused\n"
        "import ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused\n"
        "import ska_pst_dsp_tpu_torch.ops.kernels.ifft_fused\n"
        "import ska_pst_dsp_tpu_torch.ops.kernels.analysis_padded_fused\n"
        "import ska_pst_dsp_tpu_torch.ops.kernels.chan_dft_fused\n"
        "import ska_pst_dsp_tpu_torch.ops.kernels.ifft_big\n"
        "from ska_pst_dsp_tpu_torch.entry import mid_round_trip\n"
        "mid_round_trip('cpu')\n"
        "fn, args = entry('cpu', n_dat=60000)\n"
        "rr, ri = fn(*args)\n"
        "import ska_pst_dsp_tpu_torch.oracle, ska_pst_dsp_tpu_torch.io.dada\n"
        "import ska_pst_dsp_tpu_torch.verify.util\n"
        "def named(p): return sorted(m for m in sys.modules if m == p or m.startswith(p + '.'))\n"
        "print(json.dumps({'jax': named('jax'), 'pkg': named('ska_pst_dsp_tpu'),"
        " 'shape': list(rr.shape)}))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["jax"] == [] and got["shape"][:2] == [2, 1]
    assert got["pkg"] == []
