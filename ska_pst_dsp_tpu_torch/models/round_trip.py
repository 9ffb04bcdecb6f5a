"""Analysis -> Golden-inversion round trips as ``nn.Module``s.

:class:`PFBRoundTrip` (SKA-Low) runs the fused chain the JAX package times
on its chip (bench.py: ``polyphase_analysis_fused(..., time_major=True,
keep_padding=True)`` then ``polyphase_synthesis_fused(...,
time_major_in=True, valid_len=nb)``): two CUDA kernels — the analysis,
and the inversion's frontend and epilogue fused in one
(:mod:`..ops.kernels.inversion_fused`). :class:`PaddedPFBRoundTrip` (SKA-Mid) runs
bench.py's mid chain (``polyphase_analysis_padded_fused(...,
time_major=True)`` then ``polyphase_synthesis_fused(...,
time_major_in=True)``) on five: padded fold, channel DFT, frontend and the
out-of-core epilogue's two launches. Both hand over time-major with no
copy between the stages; ``reference`` runs the same chain through the
kernels' plain versions on the same buffers.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.profiling import spanned
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from ..convert import padded_round_trip_state, round_trip_state
from ..ops.analysis import analysis_core, chan_dft_core, padded_fold
from ..ops.kernels.analysis_fused import analysis_fused
from ..ops.kernels.analysis_padded_fused import padded_fold_fused
from ..ops.kernels.chan_dft_fused import chan_dft_ramp
from ..ops.kernels.synthesis_fused import fused_inversion
from ..ops.synthesis import inversion_core


class PFBRoundTrip(nn.Module):
    """Oversampled analysis PFB followed by its Golden inversion.

    Input (n_pol, n_dat) complex64 on the module's device; output
    (n_pol, 1, n_out) complex64, the reconstructed stream delayed by
    ``geometry.total_sample_shift`` samples."""

    #: state entries held as buffers; the first is the analysis filter
    BUFFERS = ("f2d", "ramp", "t_taper", "dr", "perm", "elem")
    make_state = staticmethod(round_trip_state)

    def __init__(self, n_chan: int, os_factor: Union[Rational, str],
                 input_fft_length: int, input_overlap: int):
        super().__init__()
        self.os_factor = Rational.coerce(os_factor)
        self.n_chan = n_chan
        self.step = geometry.analysis_step(n_chan, self.os_factor)
        self.geom = geometry.SynthesisGeometry(
            n_chan, input_fft_length, input_overlap, self.os_factor
        )
        for name in self.BUFFERS:
            self.register_buffer(name, None)

    @classmethod
    def from_filter(cls, filt, n_chan: int, os_factor, input_fft_length: int,
                    input_overlap: int, *, device="cuda", **state_kwargs):
        """Build the state with :attr:`make_state` (keyword arguments go to
        it) and load it onto ``device`` (the card unless the caller asks
        for the CPU)."""
        m = cls(n_chan, os_factor, input_fft_length, input_overlap)
        return m.load_state(
            cls.make_state(filt, n_chan, os_factor, input_fft_length,
                           input_overlap, **state_kwargs),
            device,
        )

    def load_state(self, state: Dict[str, Optional[np.ndarray]], device) -> "PFBRoundTrip":
        """Turn a :attr:`make_state` dict into buffers."""
        for name in self.BUFFERS:
            v = state.get("elem") if name == "elem" else state[name]
            setattr(self, name, None if v is None else torch.as_tensor(v, device=device))
        filt = getattr(self, self.BUFFERS[0])
        if filt.shape[1] != self.n_chan or self.perm.shape != (self.n_chan,):
            raise ValueError("state does not match the module's channel count")
        return self

    @spanned("forward")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._invert(analysis_fused(x, self.f2d, self.ramp, self.step))

    def reference(self, x: torch.Tensor) -> torch.Tensor:
        """The same chain through the kernels' plain PyTorch versions."""
        return self._invert_plain(analysis_core(x, self.f2d, self.ramp, self.step))

    def _invert(self, chan: torch.Tensor) -> torch.Tensor:
        """Frontend kernel + epilogue on time-major (n_pol, nb, n_chan)."""
        return fused_inversion(
            chan, self.t_taper, self.dr, self.perm, self.elem, self.geom,
            spans_nyquist=True, valid_len=chan.shape[1],
        )

    def _invert_plain(self, chan: torch.Tensor) -> torch.Tensor:
        return inversion_core(chan, self.t_taper, self.dr, self.perm, self.elem,
                              self.geom, spans_nyquist=True)


class PaddedPFBRoundTrip(PFBRoundTrip):
    """Zero-padded (SKA-Mid) analysis PFB followed by its Golden inversion.

    Output spectrum k is computed from the ``padded_taps`` samples before
    ``k * step`` (zero before the stream start) and the spectra are
    advanced by the filter's group delay, so the output is the input
    delayed by ``output_overlap - 1`` samples at mid."""

    BUFFERS = ("f2d_rev", "chan_const", "t_taper", "dr", "perm", "elem")
    make_state = staticmethod(padded_round_trip_state)

    def load_state(self, state, device) -> "PaddedPFBRoundTrip":
        super().load_state(state, device)
        self.delay = int(state["delay"])
        return self

    @spanned("forward")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = padded_fold_fused(x, self.f2d_rev, self.step)
        return self._invert(chan_dft_ramp(g, self.chan_const, 0, self.delay))

    def reference(self, x: torch.Tensor) -> torch.Tensor:
        """The same chain through the kernels' plain PyTorch versions."""
        g = padded_fold(x, self.f2d_rev, self.step)
        return self._invert_plain(chan_dft_core(g, self.chan_const, 0, self.delay))
