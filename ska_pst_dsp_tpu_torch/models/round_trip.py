"""SKA-Low analysis -> Golden-inversion round trip as one ``nn.Module``.

The forward pass is the fused chain the JAX package times on its chip
(bench.py: ``polyphase_analysis_fused(..., time_major=True,
keep_padding=True)`` then ``polyphase_synthesis_fused(...,
time_major_in=True, valid_len=nb)``): three CUDA kernels — analysis,
inversion frontend, epilogue — with a time-major handoff and no copy in
between. :meth:`PFBRoundTrip.reference` runs the same chain through the
kernels' plain versions on the same buffers.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ska_pst_dsp_tpu.utils import geometry
from ska_pst_dsp_tpu.utils.rational import Rational

from ..convert import round_trip_state
from ..ops.analysis import analysis_core
from ..ops.kernels.analysis_fused import analysis_fused
from ..ops.kernels.synthesis_fused import fused_inversion
from ..ops.synthesis import epilogue, frontend

_BUFFERS = ("f2d", "ramp", "t_taper", "dr", "perm", "elem")


class PFBRoundTrip(nn.Module):
    """Oversampled analysis PFB followed by its Golden inversion.

    Input (n_pol, n_dat) complex64 on the module's device; output
    (n_pol, 1, n_out) complex64, the reconstructed stream delayed by
    ``geometry.total_sample_shift`` samples."""

    def __init__(self, n_chan: int, os_factor: Union[Rational, str],
                 input_fft_length: int, input_overlap: int):
        super().__init__()
        self.os_factor = Rational.coerce(os_factor)
        self.n_chan = n_chan
        self.step = geometry.analysis_step(n_chan, self.os_factor)
        self.geom = geometry.SynthesisGeometry(
            n_chan, input_fft_length, input_overlap, self.os_factor
        )
        for name in _BUFFERS:
            self.register_buffer(name, None)

    @classmethod
    def from_filter(cls, filt, n_chan: int, os_factor, input_fft_length: int,
                    input_overlap: int, *, device="cpu", **state_kwargs):
        """Build the state with :func:`..convert.round_trip_state` (keyword
        arguments go to it) and load it onto ``device``."""
        m = cls(n_chan, os_factor, input_fft_length, input_overlap)
        return m.load_state(
            round_trip_state(filt, n_chan, os_factor, input_fft_length,
                             input_overlap, **state_kwargs),
            device,
        )

    def load_state(self, state: Dict[str, Optional[np.ndarray]], device) -> "PFBRoundTrip":
        """Turn a :func:`..convert.round_trip_state` dict into buffers."""
        for name in _BUFFERS:
            v = state.get("elem") if name == "elem" else state[name]
            setattr(self, name, None if v is None else torch.as_tensor(v, device=device))
        if self.f2d.shape[1] != self.n_chan or self.perm.shape != (self.n_chan,):
            raise ValueError("state does not match the module's channel count")
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chan = analysis_fused(x, self.f2d, self.ramp, self.step)
        return fused_inversion(
            chan, self.t_taper, self.dr, self.perm, self.elem, self.geom,
            spans_nyquist=True, valid_len=chan.shape[1],
        )

    def reference(self, x: torch.Tensor) -> torch.Tensor:
        """The same chain through the kernels' plain PyTorch versions."""
        g = self.geom
        chan = analysis_core(x, self.f2d, self.ramp, self.step)
        n_blocks = g.n_blocks(chan.shape[1])
        L = g.input_fft_length
        fn = frontend(chan, self.t_taper, self.dr, self.perm, L, g.input_keep,
                      (L // 2 + g.discard) % L, n_blocks)
        out = epilogue(
            fn.reshape(x.shape[0], n_blocks, g.output_fft_length), self.elem,
            g.output_overlap, g.fn_width // 2,
            self.os_factor.de / self.os_factor.nu, n_blocks,
        )
        return out.reshape(x.shape[0], 1, -1)
