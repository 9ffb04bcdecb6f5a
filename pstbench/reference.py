"""The plain reference the benchmark holds the program to.

A frozen copy of the SKA PST Golden model's math, written again from its
Matlab semantics in plain PyTorch: the oversampled polyphase analysis
(polyphase_analysis.m:56-120), the zero-padded analysis
(polyphase_analysis_padded.m:61-156) and the Golden FFT inversion
(polyphase_synthesis.m:112-316). It imports nothing of the program: it
takes the configuration and the prototype filter and works out the padded
filter, the derotation, the deripple and the taper itself
(:mod:`pstbench.design`), in float64 by default, in blocks of spectra and
of inversion blocks so that it fits on the card beside the kept outputs.

``precision="bf16"`` rounds every stage's input and output to bfloat16
(computing between them in float32): the control that the comparison has
to fail.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import design

#: bytes of complex128 frames that one block of the work holds at once
BLOCK_BYTES = 1 << 29


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The round trip's integer geometry (pad_filter.m, polyphase_*.m)."""

    n_chan: int
    nu: int
    de: int
    taps: int
    L: int
    overlap: int
    padded: bool

    @property
    def step(self) -> int:
        return self.n_chan * self.de // self.nu

    @property
    def fl(self) -> int:
        """Taps padded to whole channels."""
        return -(-self.taps // self.n_chan) * self.n_chan

    @property
    def ramp_period(self) -> int:
        return self.n_chan // math.gcd(self.step, self.n_chan)

    @property
    def keep(self) -> int:
        return self.L - 2 * self.overlap

    @property
    def fn_width(self) -> int:
        return _exact(self.L * self.de, self.nu)

    @property
    def discard(self) -> int:
        return (self.L - self.fn_width) // 2

    @property
    def n_out_fft(self) -> int:
        return self.fn_width * self.n_chan

    @property
    def out_overlap(self) -> int:
        return _exact(self.overlap * self.de, self.nu) * self.n_chan

    @property
    def out_keep(self) -> int:
        return self.n_out_fft - 2 * self.out_overlap

    @property
    def delay(self) -> int:
        """Spectra the padded analysis advances its output by."""
        return -(-(self.taps - 1) // (2 * self.step)) if self.padded else 0

    def spectra(self, n_dat: int) -> int:
        return n_dat // self.step if self.padded else (n_dat - self.fl) // self.step

    def blocks(self, n_spectra: int) -> int:
        return max(0, (n_spectra - 2 * self.overlap) // self.keep)

    def out_len(self, n_dat: int) -> int:
        return self.blocks(self.spectra(n_dat)) * self.out_keep

    def in_len(self, n_blocks: int) -> int:
        """Samples a one-shot round trip needs to give ``n_blocks`` blocks."""
        spectra = n_blocks * self.keep + 2 * self.overlap
        return spectra * self.step + (0 if self.padded else self.fl)


def _exact(num: int, den: int) -> int:
    if num % den:
        raise ValueError(f"{num}/{den} is not integral")
    return num // den


def geometry(cfg: dict) -> Geometry:
    nu, de = design.os_parts(cfg)
    return Geometry(cfg["channels"], nu, de, cfg["fir_filter_taps"], cfg["input_fft_length"],
                    cfg["input_overlap"], cfg["analysis"] == "polyphase_analysis_padded")


class Reference:
    """The round trip of one configuration on ``device`` at ``precision``
    (``fp64``, ``fp32`` or ``bf16``)."""

    def __init__(self, cfg: dict, filt: np.ndarray, device, precision: str = "fp64"):
        self.g = g = geometry(cfg)
        self.device = torch.device(device)
        self.precision = precision
        self.real = torch.float64 if precision == "fp64" else torch.float32
        f = np.zeros(g.fl)
        f[: filt.size] = filt
        self.filt = self._q(torch.as_tensor(f, dtype=self.real, device=self.device))
        self.dr = self._q(torch.as_tensor(
            design.deripple(np.asarray(filt, dtype=np.float64), g.n_chan, g.fn_width // 2)
            if cfg["deripple"] else np.ones(g.fn_width), dtype=self.real, device=self.device))
        self.taper = self._q(torch.as_tensor(
            design.taper(cfg["temporal_taper"], g.L, g.overlap), dtype=self.real,
            device=self.device))

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        """Round to the control's storage precision (a no-op but for bf16)."""
        if self.precision != "bf16":
            return t
        if t.is_complex():
            return torch.complex(t.real.to(torch.bfloat16).float(),
                                 t.imag.to(torch.bfloat16).float())
        return t.to(torch.bfloat16).float()

    def _complex(self, x: torch.Tensor) -> torch.Tensor:
        ctype = torch.complex128 if self.real == torch.float64 else torch.complex64
        return self._q(torch.as_tensor(x, device=self.device).to(ctype))

    # -- analysis --------------------------------------------------------
    def _spectra_plain(self, x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """Spectra ``k`` of the single-stage analysis, time-major
        (n_pol, len(k), n_chan): window, circular shift by step*k mod
        n_chan, fold, and n_chan * FFT (the reference's conjugated,
        n_chan^2-scaled inverse DFT)."""
        g = self.g
        frames = x.unfold(-1, g.fl, g.step)[:, k]
        folded = self._q((frames * self.filt).reshape(
            x.shape[0], k.numel(), g.fl // g.n_chan, g.n_chan).sum(dim=-2))
        shift = (g.step * k) % g.n_chan
        j = torch.arange(g.n_chan, device=x.device)
        rolled = folded.gather(-1, ((j[None, :] - shift[:, None]) % g.n_chan)
                               .expand(x.shape[0], -1, -1))
        return self._q(torch.fft.fft(rolled, dim=-1) * g.n_chan)

    def _spectra_padded(self, xs: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """Raw spectra ``k`` of the zero-padded analysis from ``xs``, the
        stream behind fl zeros: the newest fl samples before k*step, time
        reversed, times the filter, folded, barrel-rotated by
        ((nu - k mod nu) * (n_chan - step)) mod n_chan where k mod nu is not
        0, then n_chan^2 * IFFT."""
        g = self.g
        frames = xs.unfold(-1, g.fl, g.step)[:, k].flip(-1)
        y = self._q((frames * self.filt).reshape(
            xs.shape[0], k.numel(), g.fl // g.n_chan, g.n_chan).sum(dim=-2))
        bri = k % g.nu
        shift = torch.where(bri == 0, torch.zeros_like(bri),
                            ((g.nu - bri) * (g.n_chan - g.step)) % g.n_chan)
        j = torch.arange(g.n_chan, device=xs.device)
        rolled = y.gather(-1, ((j[None, :] + shift[:, None]) % g.n_chan)
                          .expand(xs.shape[0], -1, -1))
        return self._q(torch.fft.ifft(rolled, dim=-1) * float(g.n_chan * g.n_chan))

    def analysis(self, x) -> torch.Tensor:
        """(n_pol, n_dat) stream -> time-major spectra (n_pol, nb, n_chan);
        the padded analysis's output advanced by its delay, circularly over
        nb as the reference's ``circshift``."""
        g = self.g
        x = self._complex(x)
        nb = g.spectra(x.shape[-1])
        if g.padded:
            x = torch.cat([x.new_zeros((x.shape[0], g.fl)), x], dim=-1)
        out = x.new_empty((x.shape[0], nb, g.n_chan))
        per = max(1, BLOCK_BYTES // (16 * x.shape[0] * g.fl))
        for a in range(0, nb, per):
            k = torch.arange(a, min(nb, a + per), device=x.device)
            out[:, a:a + k.numel()] = (self._spectra_padded(x, (k + g.delay) % nb)
                                       if g.padded else self._spectra_plain(x, k))
        return out

    # -- inversion -------------------------------------------------------
    def inversion(self, spec: torch.Tensor) -> torch.Tensor:
        """Time-major fine channels (n_pol, nb, n_chan) -> (n_pol, n_blocks *
        out_keep): overlap-save blocks of L (hop keep), tapered, FFT,
        fftshift, the central fn_width bins deripple'd, assembled channel by
        channel, rolled by -fn_width/2 (the band spans the Nyquist zone),
        IFFT times de/nu, the output overlap dropped at both ends."""
        g = self.g
        n_pol = spec.shape[0]
        n_blocks = g.blocks(spec.shape[1])
        out = spec.new_empty((n_pol, n_blocks * g.out_keep))
        frames_all = spec.unfold(1, g.L, g.keep)  # (P, n_blocks, C, L)
        per = max(1, BLOCK_BYTES // (16 * n_pol * g.n_chan * g.L))
        for a in range(0, n_blocks, per):
            frames = frames_all[:, a:a + per]
            nbk = frames.shape[1]
            s = self._q(torch.fft.fftshift(torch.fft.fft(self._q(frames * self.taper), dim=-1),
                                           dim=-1))
            fine = self._q(s[..., g.discard:g.discard + g.fn_width] * self.dr)
            flat = torch.roll(fine.reshape(n_pol, nbk, g.n_out_fft), -(g.fn_width // 2), dims=-1)
            big = torch.fft.ifft(flat, dim=-1) * (g.de / g.nu)
            kept = self._q(big[..., g.out_overlap:g.n_out_fft - g.out_overlap])
            out[:, a * g.out_keep:(a + nbk) * g.out_keep] = kept.reshape(n_pol, -1)
        return out

    def round_trip(self, x) -> torch.Tensor:
        """(n_pol, n_dat) stream -> (n_pol, out_len(n_dat)) reconstruction."""
        return self.inversion(self.analysis(x))
