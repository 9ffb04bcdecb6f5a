"""The plain reference of the ``pst`` kind: an SKA-Low PST node's inversion
of LowCBF's PST beam, each coarse channel coherently dedispersed inside it.

Written again from the reference's Matlab semantics and dspsr's
dedispersion in plain PyTorch, float64 by default. For each coarse channel
of each polarisation, its ``kept_channels`` monotonic fine channels
(TwoStageInverseFilterBank.m:100-150, ``combine`` 1) go through the Golden
inversion (polyphase_synthesis.m:112-316): overlap-save frames of L (hop
``keep``), the tukey taper, the L-point FFT, fftshifted, the passband's
``fn_width`` bins derippled, assembled in channel order, rolled by
-fn_width/2 (the band spans the Nyquist zone); then, as dspsr's
InverseFilterbank with a dedispersion response (ska-pst-dsp-model
python/verify/test_dedispersion.py:54-321), the assembled spectrum times
the channel's chirp

    H_c(df) = exp(+2j*pi * k_DM * DM * df^2 / (f_c^2 * (f_c + df)))

at the FFT bins' offsets df in [-bw/2, bw/2) from the channel's centre f_c,
computed here from the DM and f_c in float64; then the IFFT, the output
overlap dropped at both ends and the gain de/nu. The assembled spectrum
holds the lowest kept fine channel's centre at bin 0 and the middle one's,
the coarse channel's centre, at bin N/2 (the inversion's output is the
coarse channel shifted by half its band), so bin k lies at offset
df = (k - N/2)/N * bw.

The overlap dropped is dspsr's discard of taper plus response
(:func:`overlap`): each kept sample's chirp reads the samples within the
chirp's reach on either side, and those have to lie outside the tukey
taper's edges, which span the configuration's ``input_overlap``. So each
frame discards that overlap plus the reach of the band's lowest channel (its
widest chirp), in whole fine samples rounded up to a multiple of nu, and
hops by what is left.

It imports nothing of the program: it takes the configuration (the
LowCBF stage, its ``dm``, its coarse channels' plan) and the prototype
filter, and works out the deripple and the taper through
:class:`pstbench.reference.Reference`. ``precision="bf16"`` rounds every
step's input and output, the chirp among them, to bfloat16 (computing
between them in float32): the control.

Departures, each with its reason:

* One call on a stretch of the stream: the stream's blocks only delay
  samples (InverseFilterBank.m's carry), so the values of the samples both
  emit are the same; the caller aligns the stretch
  (:mod:`pstbench.kinds.pst`).
* The deripple is worked out at the slab's channel count
  (``kept_channels``), as polyphase_synthesis.m works it out from the
  number of channels it is given.
* The coarse channels run in groups, and each in blocks of frames, so that
  the work fits on the card beside the kept outputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pstbench import design
from pstbench.reference import BLOCK_BYTES, Reference, geometry

#: dispersion constant, s MHz^2 / (pc cm^-3) (Manchester & Taylor)
KDM = 4.149377593e3
#: coarse channels a group of the inversion takes at a time
GROUP = 64


def reach(dm: float, centre_mhz: float, bw_mhz: float) -> float:
    """The chirp's reach of a channel at ``centre_mhz``, in samples at
    ``bw_mhz`` complex sampling: the dispersion delay of its lower edge
    behind its centre, KDM * DM * ((f_c - bw/2)^-2 - f_c^-2) s."""
    lo = centre_mhz - bw_mhz / 2
    return KDM * dm * (1.0 / lo**2 - 1.0 / centre_mhz**2) * bw_mhz * 1e6


def overlap(cfg: dict) -> int:
    """The fine samples each inversion frame discards a side: the taper's
    ``input_overlap`` plus the lowest coarse channel's :func:`reach` in fine
    samples (one is kept * de / nu output samples), rounded up to a multiple
    of nu so that the output discard is whole samples."""
    nu, de = design.os_parts(cfg)
    per = cfg["kept_channels"] * de / nu
    need = cfg["input_overlap"] + math.ceil(
        abs(reach(float(cfg["dm"]), float(centres(cfg)[0]), float(cfg["coarse_bw_mhz"]))) / per)
    return -(-need // nu) * nu


def centres(cfg: dict) -> np.ndarray:
    """The centre frequencies (MHz) of the configuration's coarse channels,
    in the order the node receives them."""
    return cfg["first_coarse_centre_mhz"] + cfg["coarse_bw_mhz"] * np.arange(
        cfg["coarse_channels"])


def chirp(n: int, dm: float, centre_mhz: float, bw_mhz: float) -> torch.Tensor:
    """(n,) complex128: the dedispersion chirp of a channel at ``centre_mhz``
    at the n bins of the assembled spectrum of its ``bw_mhz`` band, bin k at
    offset (k - n/2)/n * bw, the phase in float64."""
    df = (torch.arange(n, dtype=torch.float64) - n // 2) / n * bw_mhz
    phase = 2.0 * math.pi * KDM * 1e6 * dm * df**2 / (centre_mhz**2 * (centre_mhz + df))
    return torch.polar(torch.ones_like(phase), phase)


class Pst:
    """The node's dedispersing inversion of one configuration on ``device``
    at ``precision`` (``fp64`` or ``bf16``)."""

    def __init__(self, cfg: dict, filt: np.ndarray, device, precision: str = "fp64"):
        if precision not in ("fp64", "bf16"):
            raise ValueError(f"no {precision} reference")
        self.kept = cfg["kept_channels"]
        slab = {**cfg, "channels": self.kept, "analysis": "polyphase_analysis"}
        # the taper and the deripple at the configuration's overlap, the
        # frames at the wider discard
        self.inverse = Reference(slab, filt, device, precision)
        self.g = geometry({**slab, "input_overlap": overlap(cfg)})
        self.device = self.inverse.device
        self.dm, self.bw = float(cfg["dm"]), float(cfg["coarse_bw_mhz"])
        self.centres = centres(cfg)
        self._chirps = {}

    def chirps(self, c0: int, c1: int) -> torch.Tensor:
        """(c1 - c0, N) chirps of coarse channels [c0, c1), on the device,
        rounded to the precision."""
        key = (c0, c1)
        if key not in self._chirps:
            h = torch.stack([chirp(self.g.n_out_fft, self.dm, float(f), self.bw)
                             for f in self.centres[c0:c1]])
            self._chirps[key] = self.inverse._complex(h)
        return self._chirps[key]

    def inversion(self, x: torch.Tensor) -> torch.Tensor:
        """(n_pol, coarse * kept, T) channel-major fine channels, coarse
        channel c's ``kept`` channels in monotonic order at rows [c*kept,
        (c+1)*kept) -> (n_pol, coarse, n_blocks * out_keep): each coarse
        channel inverted and dedispersed at its centre."""
        g = self.g
        n_pol, rows, n_dat = x.shape
        coarse = rows // self.kept
        n_blocks = g.blocks(n_dat)
        real = self.inverse.real
        out = torch.empty((n_pol, coarse, n_blocks * g.out_keep),
                          dtype=torch.complex128 if real == torch.float64 else torch.complex64,
                          device=self.device)
        q = self.inverse._q
        for p in range(n_pol):
            for c0 in range(0, coarse, GROUP):
                c1 = min(coarse, c0 + GROUP)
                h = self.chirps(c0, c1)
                slab = self.inverse._complex(
                    x[p, c0 * self.kept:c1 * self.kept].reshape(c1 - c0, self.kept, n_dat))
                frames_all = slab.unfold(-1, g.L, g.keep)  # (nc, kept, n_blocks, L)
                per = max(1, BLOCK_BYTES // (16 * (c1 - c0) * self.kept * g.L))
                for a in range(0, n_blocks, per):
                    frames = frames_all[:, :, a:a + per].transpose(1, 2)  # (nc, nbk, kept, L)
                    nbk = frames.shape[1]
                    s = q(torch.fft.fftshift(
                        torch.fft.fft(q(frames * self.inverse.taper), dim=-1), dim=-1))
                    fine = q(s[..., g.discard:g.discard + g.fn_width] * self.inverse.dr)
                    flat = torch.roll(fine.reshape(c1 - c0, nbk, g.n_out_fft),
                                      -(g.fn_width // 2), dims=-1)
                    big = torch.fft.ifft(q(flat * h[:, None, :]), dim=-1) * (g.de / g.nu)
                    kept = q(big[..., g.out_overlap:g.n_out_fft - g.out_overlap])
                    out[p, c0:c1, a * g.out_keep:(a + nbk) * g.out_keep] = kept.reshape(
                        c1 - c0, -1)
        return out
