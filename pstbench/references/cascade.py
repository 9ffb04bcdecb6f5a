"""The plain reference of the ``cascade`` kind: SKA-Low's PST chain.

Three steps, written again from the reference's Matlab semantics in plain
PyTorch, float64 by default:

1. the SPS stage-1 coarse channeliser, the oversampled single-stage
   analysis (polyphase_analysis.m:56-120), through
   :meth:`pstbench.reference.Reference.analysis`;
2. the LowCBF firmware PST filterbank on every coarse channel of each
   polarisation (TwoStageFilterBank.m:60-80, polyphase_analysis_lowcbf.m,
   PSTFilterbank.m:7-45): the stream behind half the FIR length of zeros
   (the firmware's first call), windows of the FIR length at a hop of
   ``channels * de / nu``, times the taps, folded onto ``channels``, /2^9,
   the forward FFT, fftshifted, /128, the quarter-turn derotation
   ``exp(2j*pi*mod(s*(-channels/2:channels/2-1), 4)/4)`` of spectrum s, the
   ``kept_channels`` middle channels (fftshifted, so in monotonic
   frequency order), times the wrapper's 2^9 * 2048 * 256;
3. the Golden inversion (polyphase_synthesis.m:112-316) of each coarse
   channel's slab of ``kept_channels`` channels, oversampled and
   monotonic with ``combine`` 1 (TwoStageInverseFilterBank.m:100-150),
   through :meth:`pstbench.reference.Reference.inversion`: tukey taper,
   FFT, the passband bins derippled, assembled in the slab's channel
   order, IFFT.

It imports nothing of the program: it takes the configuration (the top
level is stage 1, ``stage2`` the LowCBF stage) and the two prototype
filters. ``precision="bf16"`` rounds every step's input and output to
bfloat16 (computing between them in float32): the control.

Departures from the Matlab, each with its reason:

* One call on the whole input from the stream's start: the reference's
  block loop (sgcht's 64 Mi blocks) and the stages' truncation of each
  block's output to whole chunks only delay samples, so the values of the
  samples both emit are the same; the caller aligns a stretch of the
  stream (:mod:`pstbench.kinds.cascade`).
* The firmware's fixed-point arithmetic is not modelled: its scalings are
  applied in floating point, as PSTFilterbank.m does.
* The deripple is worked out at the slab's channel count
  (``kept_channels``), as polyphase_synthesis.m works it out from the
  number of channels it is given.
* Stage 2 and the inversion run in groups of coarse channels, and each in
  blocks of spectra, so that the work fits on the card beside the kept
  outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from pstbench import design
from pstbench.reference import BLOCK_BYTES, Reference

#: the firmware's scalings (PSTFilterbank.m: /2^9 after the FIR, /128 after
#: the FFT; polyphase_analysis_lowcbf.m: times 2^9 * 2048 * 256)
FIR_SCALE, FFT_SCALE, WRAPPER_SCALE = 2.0**-9, 1.0 / 128.0, 2.0**9 * 2048 * 256
#: coarse channels a group of stage 2 and the inversion takes at a time
GROUP = 64


class Cascade:
    """The chain of one configuration on ``device`` at ``precision``
    (``fp64`` or ``bf16``)."""

    def __init__(self, cfg: dict, filt: np.ndarray, filt2: np.ndarray, device,
                 precision: str = "fp64"):
        if precision not in ("fp64", "bf16"):
            raise ValueError(f"no {precision} reference")
        c2 = cfg["stage2"]
        self.stage1 = Reference(cfg, filt, device, precision)
        self.device = self.stage1.device
        self.n_chan1 = cfg["channels"]
        self.n_chan2, self.kept = c2["channels"], c2["kept_channels"]
        self.nfilt = c2["fir_filter_taps"]
        nu, de = design.os_parts(c2)
        self.step2 = self.n_chan2 * de // nu
        if self.nfilt % self.n_chan2 or (self.n_chan2 - self.kept) % 2:
            raise ValueError("stage 2 needs whole channels of taps and an even chomp")
        self.pad = self.nfilt // 2
        self.lo = (self.n_chan2 - self.kept) // 2
        q, real = self.stage1._q, self.stage1.real
        self.taps = q(torch.as_tensor(np.asarray(filt2, dtype=np.float64), dtype=real,
                                      device=self.device)
                      .reshape(self.nfilt // self.n_chan2, self.n_chan2))
        quarter = torch.tensor([1, 1j, -1, -1j], dtype=torch.complex128)
        bins = torch.arange(-(self.n_chan2 // 2), self.n_chan2 // 2)
        rot = quarter[(torch.arange(4)[:, None] * -bins) % 4]
        self.rot = rot.to(self.device, torch.complex128 if real == torch.float64
                          else torch.complex64)
        # the slab's inversion: a single-stage geometry of kept_channels
        self.inverse = Reference({**c2, "channels": self.kept, "analysis": "polyphase_analysis"},
                                 filt2, device, precision)
        self.g2 = self.inverse.g

    def lowcbf(self, y: torch.Tensor) -> torch.Tensor:
        """Streams (S, T1) from their start -> time-major kept channels
        (S, T2, kept), T2 = (T1 + pad - nfilt) // step2 (the last whole
        window is not emitted, as PSTFilterbank.m's loop leaves it)."""
        q = self.stage1._q
        y = q(torch.cat([y.new_zeros((y.shape[0], self.pad)), y], dim=-1))
        n_spec = max(0, (y.shape[-1] - self.nfilt) // self.step2)
        out = y.new_empty((y.shape[0], n_spec, self.kept))
        frames_all = y.unfold(-1, self.nfilt, self.step2)
        per = max(1, BLOCK_BYTES // (16 * y.shape[0] * self.nfilt))
        for a in range(0, n_spec, per):
            frames = frames_all[:, a:min(n_spec, a + per)]
            n = frames.shape[1]
            fft_in = q((frames.reshape(*frames.shape[:2], -1, self.n_chan2) * self.taps)
                       .sum(dim=-2) * FIR_SCALE)
            d1 = q(torch.fft.fftshift(torch.fft.fft(fft_in, dim=-1), dim=-1) * FFT_SCALE)
            rot = self.rot[torch.arange(a, a + n, device=self.device) % 4]
            out[:, a:a + n] = q(d1[..., self.lo:self.lo + self.kept]
                                * rot[:, self.lo:self.lo + self.kept] * WRAPPER_SCALE)
        return out

    def _groups(self, spec1: torch.Tensor, coarse: int):
        """Stage 1's time-major spectra -> (polarisation, first coarse
        channel, its group's streams (S, T1))."""
        for p in range(spec1.shape[0]):
            for c in range(0, coarse, GROUP):
                yield p, c, spec1[p, :, c:min(coarse, c + GROUP)].transpose(0, 1)

    def analyses(self, x, coarse: int = None) -> torch.Tensor:
        """(n_pol, n_dat) stream -> (n_pol, coarse * kept, T2): stage 2's
        channels of the first ``coarse`` coarse channels (default all),
        coarse-channel-major, as TwoStageFilterBank lays them out."""
        spec1 = self.stage1.analysis(x)
        coarse = self.n_chan1 if coarse is None else coarse
        parts = [self.lowcbf(y) for _, _, y in self._groups(spec1, coarse)]
        fine = torch.cat(parts).reshape(spec1.shape[0], coarse, -1, self.kept)
        return fine.permute(0, 1, 3, 2).reshape(spec1.shape[0], coarse * self.kept, -1)

    def cascade(self, x, coarse: int = None) -> torch.Tensor:
        """(n_pol, n_dat) stream -> (n_pol, coarse, n_blocks * out_keep):
        each of the first ``coarse`` coarse channels (default all)
        reconstructed from its stage-2 channels."""
        spec1 = self.stage1.analysis(x)
        coarse = self.n_chan1 if coarse is None else coarse
        out = None
        for p, c, y in self._groups(spec1, coarse):
            z = self.inverse.inversion(self.lowcbf(y))
            if out is None:
                out = z.new_empty((spec1.shape[0], coarse, z.shape[-1]))
            out[p, c:c + z.shape[0]] = z
        return out
