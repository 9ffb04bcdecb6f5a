"""Oversampled polyphase analysis filterbank (SKA-Low style), composed.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.analysis` (analysis.py:52-173):
the reference's per-block ``circshift`` commutes with the phase fold and
becomes a per-bin phase ramp under the DFT, so

    out[k, q] = block * FFT(folded_k)[q] * exp(-2j*pi*q*(step*(k+block0) % block)/block)

(upper sideband). The ramp is periodic in k with period
``block / gcd(step, block)`` (= nu for every integral geometry), so a table
of that many rows, indexed by ``(k + block0) % period``, is the whole ramp.

:func:`analysis_plain` (:func:`analysis_core`, stored time-major, or
channel-major over a table of bins) is the plain version of the fused
analysis kernel (:mod:`.kernels.analysis_fused`).

The zero-padded (SKA-Mid) variant (analysis.py:99-125, 176-205) folds the
time-reversed filter against the ``padded_taps`` samples before each
output step, then reverses, runs ``block^2 * IFFT``, derotates with the
same ramp schedule and advances the stream by the group delay.
:func:`padded_fold` and :func:`chan_dft_core` are the plain versions of its
two kernels (:mod:`.kernels.analysis_padded_fused`,
:mod:`.kernels.chan_dft_fused`); the second replaces reverse-then-IFFT by
a forward FFT times :func:`padded_chan_const`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from . import cfft
from .framing import frame


def _phase_ramp(block: int, step: int, nblocks: int, k0: int) -> Tuple[np.ndarray, np.ndarray]:
    """ramp[k, q] = exp(-2j*pi * q * (step*(k+k0) mod block) / block) as
    (re, im) float32."""
    k = np.arange(nblocks) + k0
    shift = (step * k) % block
    q = np.arange(block)
    ang = -2.0 * np.pi * q[None, :] * shift[:, None] / block
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _prep_filter(filt, block: int, reverse: bool = False) -> np.ndarray:
    """Zero-pad taps to a multiple of block (pad_filter.m:9-13) and reshape
    to (phases, block) with f2d[m, j] = f[m*block + j]."""
    filt = np.asarray(filt, dtype=np.float64).ravel()
    fl = geometry.padded_filter_length(filt.size, block)
    f = np.zeros(fl, dtype=np.float64)
    f[: filt.size] = filt
    if reverse:
        f = f[::-1]
    return f.reshape(fl // block, block).astype(np.float32)


def ramp_period(block: int, step: int) -> int:
    """Rows of the derotation ramp before it repeats."""
    return block // math.gcd(step, block)


def ramp_table(block: int, step: int) -> np.ndarray:
    """(period, block) complex64 ramp; row r serves every spectrum k with
    (k + block0) % period == r."""
    rr, ri = _phase_ramp(block, step, ramp_period(block, step), 0)
    return rr + 1j * ri


def stream(x) -> Tuple[torch.Tensor, bool]:
    """(n_pol, n_dat) complex64 tensor from a (n_pol, [1,] n_dat) complex
    tensor/array or (re, im) pair, and whether it came as a pair."""
    z, pair = cfft.as_complex(x)
    if z.ndim == 3:
        z = z[:, 0, :]
    return z, pair


def analysis_core(x: torch.Tensor, f2d: torch.Tensor, ramp: torch.Tensor,
                  step: int, block0: int = 0) -> torch.Tensor:
    """(n_pol, n_dat) complex64 -> time-major (n_pol, nblocks, block),
    nblocks = (n_dat - phases*block) // step.

    f2d: (phases, block) float32; ramp: (period, block) complex64, both on
    x's device."""
    n_pol = x.shape[0]
    phases, block = f2d.shape
    fl = phases * block
    nblocks = (x.shape[-1] - fl) // step
    frames = frame(x, fl, step, nblocks).reshape(n_pol, nblocks, phases, block)
    folded = (frames * f2d).sum(dim=-2)
    spec = cfft.fft(folded)
    rows = (torch.arange(nblocks, device=x.device) + block0) % ramp.shape[0]
    return spec * ramp[rows] * block


def analysis_plain(x: torch.Tensor, f2d: torch.Tensor, ramp: torch.Tensor, step: int,
                   block0: int = 0, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of the fused analysis's two stores:
    :func:`analysis_core`'s time-major spectra, or given ``rows`` (integer
    bins) the channel-major (n_pol, len(rows), nblocks), contiguous, whose
    row i holds bin rows[i] of every spectrum."""
    out = analysis_core(x, f2d, ramp, step, block0)
    return out if rows is None else out.index_select(-1, rows).transpose(1, 2).contiguous()


def polyphase_analysis(x, filt, block: int, os_factor: Union[Rational, str],
                       *, block0: int = 0):
    """Single-stage oversampled analysis PFB (SKA-Low / "Bunton" style).

    Args:
      x: (n_pol, 1, n_dat) or (n_pol, n_dat) complex stream, or an
        (re, im) float32 pair.
      filt: prototype lowpass FIR coefficients.
      block: number of output channels (= FFT length).
      os_factor: oversampling ratio nu/de.
      block0: absolute index of the first output spectrum (for streamed
        calls; 0 for one-shot).

    Returns (n_pol, block, nblocks), nblocks = (n_dat - padded_taps)//step;
    a complex64 tensor for complex input, an (re, im) pair for pair input.
    """
    z, pair = stream(x)
    os_factor = Rational.coerce(os_factor)
    step = geometry.analysis_step(block, os_factor)
    f2d = torch.as_tensor(_prep_filter(filt, block), device=z.device)
    ramp = torch.as_tensor(ramp_table(block, step), device=z.device)
    out = analysis_core(z, f2d, ramp, step, block0).transpose(1, 2)
    return cfft.same_kind(out, pair)


def padded_fold(x: torch.Tensor, f2d_rev: torch.Tensor, step: int) -> torch.Tensor:
    """(n_pol, n_dat) complex64 -> time-major (n_pol, n_dat // step, block):
    g[p, k, j] = sum_m f2d_rev[m, j] * x[p, k*step - fl + m*block + j],
    fl = phases*block, with x zero before the stream start."""
    phases, block = f2d_rev.shape
    fl = phases * block
    n_pol, n_dat = x.shape
    nblocks = n_dat // step
    xs = torch.cat([x.new_zeros((n_pol, fl)), x], dim=-1)
    frames = frame(xs, fl, step, nblocks).reshape(n_pol, nblocks, phases, block)
    return (frames * f2d_rev).sum(dim=-2)


def padded_chan_const(block: int, step: int) -> np.ndarray:
    """(nu, block) complex64: ``block * exp(-2j*pi*q/block)`` times the ramp
    row. Reversing a fold row and taking ``block^2 * IFFT`` equals its
    forward FFT times the first factor (analysis_padded_fused.py:303-312),
    so row ``(k + block0) % nu`` turns FFT(g_k) into output spectrum k."""
    rr, ri = _phase_ramp(block, step, ramp_period(block, step), 0)
    q = np.arange(block)
    pr = block * np.cos(-2.0 * np.pi * q / block)
    pi = block * np.sin(-2.0 * np.pi * q / block)
    rr, ri = rr.astype(np.float64), ri.astype(np.float64)
    return ((rr * pr - ri * pi) + 1j * (rr * pi + ri * pr)).astype(np.complex64)


def chan_dft_core(g: torch.Tensor, const: torch.Tensor, block0: int = 0,
                  delay: int = 0) -> torch.Tensor:
    """(n_pol, nb, block) fold rows -> FFT(g) * const[(k + block0) % nu],
    then rolled back by ``delay`` spectra along k (modulo nb, as
    ``jnp.roll``)."""
    rows = (torch.arange(g.shape[1], device=g.device) + block0) % const.shape[0]
    out = cfft.fft(g) * const[rows]
    return torch.roll(out, -delay, dims=1) if delay else out


def polyphase_analysis_padded(x, filt, block: int,
                              os_factor: Union[Rational, str], *,
                              block0: int = 0, apply_delay: bool = True):
    """Zero-padded oversampled analysis PFB (SKA-Mid / "Gunaratne" style).

    Output block k is computed from samples x[k*step - padded_taps : k*step]
    (zero before the stream start), then the stream is advanced by
    ceil((taps-1)/2/step) spectra to cancel the filter group delay;
    ``apply_delay=False`` leaves the raw timeline. Returns
    (n_pol, block, n_dat // step), same in/out kinds as
    :func:`polyphase_analysis`."""
    z, pair = stream(x)
    os_factor = Rational.coerce(os_factor)
    step = geometry.analysis_step(block, os_factor)
    f2d_rev = torch.as_tensor(_prep_filter(filt, block, reverse=True), device=z.device)
    g = padded_fold(z, f2d_rev, step)
    spec = cfft.ifft(g.flip(-1)) * float(block * block)
    ramp = torch.as_tensor(ramp_table(block, step), device=z.device)
    rows = (torch.arange(g.shape[1], device=z.device) + block0) % ramp.shape[0]
    out = spec * ramp[rows]
    if apply_delay:
        delay = geometry.padded_sample_delay_shift(np.asarray(filt).size, block, os_factor)
        out = torch.roll(out, -delay, dims=1)
    return cfft.same_kind(out.transpose(1, 2), pair)
