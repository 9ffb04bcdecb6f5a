"""Golden FFT-based PFB inversion, composed.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.synthesis` (synthesis.py:37-236).
The inversion splits at the same boundary as the fused kernels:

* :func:`frontend` — overlap-save frames (hop ``input_keep``) of the
  combine-permuted channels, temporal taper, L-point forward FFT, and the
  fftshifted passband keep + deripple as a selection of raw bins
  ``(kpos + j) mod L``; output in assembled spectrum order
  (n_pol, n_blocks, n_chan, FN_width);
* :func:`epilogue` — the backward FFT of each assembled block with the
  spectral taper / filter, the DC-centering roll by FN_width/2 when the
  channels span the Nyquist zone (polyphase_synthesis.m:265-278), the
  overlap discard and the de/nu gain.

Both are also the plain versions of the fused kernels
(:mod:`.kernels.synthesis_fused`, :mod:`.kernels.ifft_fused`,
:mod:`.kernels.ifft_big`); :func:`big_ifft_inner` and
:func:`big_ifft_outer` split the epilogue at the boundary of the two
out-of-core kernels, as plain versions of each. The spectral
taper and filter reach the epilogue as one complex factor ``elem``
pre-rolled by +roll, the contract of the fused epilogue, so
``epilogue(X) = IFFT(roll(X * elem, -roll))[lo:N-lo] * gain``.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ska_pst_dsp_tpu_torch.utils import geometry, windows
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from . import cfft
from .framing import frame


def combine_channel_permutation(n_chan: int, combine: int) -> np.ndarray:
    """Input-channel index feeding each output slot when the n_chan fine
    channels span ``combine`` coarse channels (polyphase_synthesis.m:198-238):
    half-coarse-channel shift, DSB-monotonic reorder, and half-band swaps
    within the output and coarse channels."""
    chan = np.arange(n_chan)
    if combine <= 1:
        return chan
    fcpc = n_chan // combine  # fine channels per coarse channel
    fine = (chan + fcpc // 2) % n_chan
    coarse = fine // fcpc
    fine = fine - coarse * fcpc
    coarse = (coarse + combine // 2) % combine
    fine = (fine + fcpc // 2) % fcpc
    return coarse * fcpc + fine


def _window(spec, length: int, overlap: int) -> np.ndarray:
    if isinstance(spec, str) or spec is None:
        return windows.build(spec or "no_window", length, overlap)
    return np.asarray(spec, dtype=np.float32)


def synthesis_constants(
    n_chan: int,
    input_fft_length: int,
    os_factor: Union[Rational, str],
    input_overlap: int,
    *,
    spans_nyquist: bool = True,
    deripple_coeff: Optional[np.ndarray] = None,
    temporal_taper: Union[str, np.ndarray, None] = "no_window",
    spectral_taper: Union[str, np.ndarray, None] = "no_window",
    combine: int = 1,
    monotonic: bool = False,
    spectral_filter=None,
    taper_overlap: Optional[int] = None,
) -> Dict[str, Optional[np.ndarray]]:
    """Host constants of the inversion, under the JAX package's names:
    ``t_taper`` (L,) float32, ``dr`` (FN_width,) float32 deripple (ones
    when disabled), ``perm`` (n_chan,) int32, and ``elem`` — the spectral
    taper times the spectral filter, pre-rolled by +roll, complex64, or
    None when both are identity. A ``(rows, N)`` spectral filter (one row
    a stream, stream s reading row ``s % rows``: a chirp a coarse channel,
    :func:`.dedispersion.chirp_table`) gives a ``(rows, N)`` ``elem``,
    each row rolled. The tapers' edges span ``taper_overlap`` (default
    ``input_overlap``): a discard wider than the taper leaves the chirp's
    reach of each kept edge untapered."""
    os_factor = Rational.coerce(os_factor)
    L = input_fft_length
    geom = geometry.SynthesisGeometry(n_chan, L, input_overlap, os_factor)
    fnw = geom.fn_width
    taper = input_overlap if taper_overlap is None else taper_overlap
    t_vec = _window(temporal_taper, L, taper)
    s_vec = _window(spectral_taper, n_chan * fnw, taper)

    if deripple_coeff is not None:
        from ska_pst_dsp_tpu_torch.design.fir import deripple_response

        dr = deripple_response(deripple_coeff, n_chan, fnw // 2).astype(np.float32)
    else:
        dr = np.ones(fnw, dtype=np.float32)

    perm = (
        np.arange(n_chan) if monotonic
        else combine_channel_permutation(n_chan, combine)
    ).astype(np.int32)

    elem = None
    if spectral_filter is not None or not np.all(s_vec == 1.0):
        n = n_chan * fnw
        e = np.asarray(s_vec, dtype=np.float64).astype(np.complex128)
        if spectral_filter is not None:
            if isinstance(spectral_filter, tuple):
                sf_r, sf_i = spectral_filter
            else:
                sf = np.asarray(spectral_filter)
                sf_r, sf_i = sf.real, sf.imag
            sf_r = np.asarray(sf_r, dtype=np.float32)
            sf_i = np.asarray(sf_i, dtype=np.float32)
            if (sf_r.shape != sf_i.shape or sf_r.ndim not in (1, 2) or sf_r.shape[-1] != n
                    or sf_r.shape[0] == 0):
                raise ValueError(
                    f"spectral_filter must have shape ({n},) or (rows, {n}), "
                    f"got re {sf_r.shape} / im {sf_i.shape}"
                )
            e = e * (sf_r.astype(np.float64) + 1j * sf_i.astype(np.float64))
        roll = fnw // 2 if spans_nyquist else 0
        elem = np.roll(e, roll, axis=-1).astype(np.complex64)
    return {"t_taper": t_vec, "dr": dr, "perm": perm, "elem": elem}


def frontend(x_tc: torch.Tensor, t_taper: torch.Tensor, dr: torch.Tensor,
             perm: torch.Tensor, L: int, keep: int, kpos: int,
             n_blocks: int) -> torch.Tensor:
    """(n_pol, n_dat, n_chan) complex64 view -> (n_pol, n_blocks, n_chan,
    FN_width): output channel c reads input channel perm[c]; kept bin j is
    raw DFT bin (kpos + j) mod L times dr[j]."""
    xs = x_tc.index_select(-1, perm).transpose(1, 2)  # (P, C, T)
    frames = frame(xs, L, keep, n_blocks).transpose(1, 2)  # (P, nb, C, L)
    spec = cfft.fft(frames * t_taper)
    sel = (kpos + torch.arange(dr.shape[0], device=x_tc.device)) % L
    return spec[..., sel] * dr


def epilogue(flat: torch.Tensor, elem: Optional[torch.Tensor], lo: int,
             roll: int, gain: float, n_valid: int) -> torch.Tensor:
    """(n_pol, B >= n_valid, N) assembled spectra -> (n_pol, n_valid,
    N - 2*lo): IFFT(roll(X * elem, -roll))[lo:N-lo] * gain; a (rows, N)
    elem applies row ``s % rows`` to stream s (n_pol a multiple of rows)."""
    n = flat.shape[-1]
    z = flat[:, :n_valid]
    if elem is not None and elem.ndim == 2:
        z = (z.reshape(-1, elem.shape[0], *z.shape[1:]) * elem[:, None]).reshape(z.shape)
    elif elem is not None:
        z = z * elem
    z = torch.roll(z, -roll, dims=-1)
    return cfft.ifft(z)[..., lo:n - lo] * gain


def inversion_core(x_tc: torch.Tensor, t_taper: torch.Tensor, dr: torch.Tensor,
                   perm: torch.Tensor, elem: Optional[torch.Tensor],
                   geom: geometry.SynthesisGeometry, *, spans_nyquist: bool,
                   held: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`frontend` then :func:`epilogue` on a (n_pol, n_dat, n_chan)
    view, after ``held`` (a (n_pol, h, n_chan) view of the samples that
    come before it, joined to it here) where given: the plain version of
    the fused inversion (:func:`.kernels.synthesis_fused.fused_inversion`).
    Returns (n_pol, 1, n_blocks * output_keep)."""
    if held is not None:
        x_tc = torch.cat([held, x_tc], dim=1)
    n_pol, n_dat, _ = x_tc.shape
    L = geom.input_fft_length
    n_blocks = geom.n_blocks(n_dat)
    fn = frontend(x_tc, t_taper, dr, perm, L, geom.input_keep,
                  (L // 2 + geom.discard) % L, n_blocks)
    out = epilogue(
        fn.reshape(n_pol, n_blocks, geom.output_fft_length), elem,
        geom.output_overlap, geom.fn_width // 2 if spans_nyquist else 0,
        geom.os_factor.de / geom.os_factor.nu, n_blocks,
    )
    return out.reshape(n_pol, 1, -1)


def _phase(idx: torch.Tensor, n: int) -> torch.Tensor:
    """exp(+2j*pi*idx/n) as complex64, the angle taken in float64 from the
    exact integer idx mod n."""
    ang = (idx % n).to(torch.float64) * (2.0 * np.pi / n)
    return torch.polar(torch.ones_like(ang), ang).to(torch.complex64)


def big_ifft_inner(flat: torch.Tensor, elem: Optional[torch.Tensor], n2: int,
                   n1: int) -> torch.Tensor:
    """First half of :func:`epilogue` in the four-step split N = n2*n1
    (frequency f = n1*i2 + i1): (n_pol, B, N) -> (n_pol, B, n2, n1),
    A[k2, i1] = sum_i2 (X*elem)[n1*i2 + i1] * exp(+2j*pi*i2*k2/n2)."""
    z = flat if elem is None else flat * elem
    return cfft.ifft(z.reshape(*z.shape[:-1], n2, n1), axis=-2) * float(n2)


def big_ifft_outer(a: torch.Tensor, lo: int, roll: int, gain: float) -> torch.Tensor:
    """Second half: (n_pol, B, n2, n1) -> (n_pol, B, N - 2*lo), time
    t = k2 + n2*k1 in [lo, N - lo):
    y = gain/N * exp(-2j*pi*roll*t/N) * sum_i1 A[k2, i1]
        * exp(+2j*pi*i1*k2/N) * exp(+2j*pi*i1*k1/n1)."""
    n_pol, n_b, n2, n1 = a.shape
    n = n2 * n1
    dev = a.device
    k2 = torch.arange(n2, device=dev)
    tw = _phase(k2[:, None] * torch.arange(n1, device=dev)[None, :], n)
    y = cfft.ifft(a * tw) * float(n1)  # (..., k2, k1)
    y = y[..., lo // n2:(n - lo) // n2].transpose(-1, -2).reshape(n_pol, n_b, n - 2 * lo)
    t = torch.arange(lo, n - lo, device=dev)
    return y * _phase(-roll * t, n) * (gain / n)


def polyphase_synthesis(
    x,
    input_fft_length: int,
    os_factor: Union[Rational, str],
    *,
    spans_nyquist: bool = True,
    input_overlap: Optional[int] = None,
    deripple_coeff: Optional[np.ndarray] = None,
    sample_offset: int = 0,
    temporal_taper: Union[str, np.ndarray, None] = "no_window",
    spectral_taper: Union[str, np.ndarray, None] = "no_window",
    combine: int = 1,
    monotonic: bool = False,
    spectral_filter=None,
):
    """Invert an oversampled PFB: fine channels -> original baseband stream.

    Same arguments as :func:`ska_pst_dsp_tpu.ops.polyphase_synthesis`:
    ``x`` is (n_pol, n_chan, n_dat) complex or an (re, im) pair; returns
    (n_pol, 1, n_blocks*output_keep) of the same kind.
    """
    os_factor = Rational.coerce(os_factor)
    z, pair = cfft.as_complex(x)
    if sample_offset:
        z = z[:, :, sample_offset:]
    n_chan = z.shape[1]
    L = input_fft_length
    if input_overlap is None:
        input_overlap = L // 8
    geom = geometry.SynthesisGeometry(n_chan, L, input_overlap, os_factor)
    c = synthesis_constants(
        n_chan, L, os_factor, input_overlap, spans_nyquist=spans_nyquist,
        deripple_coeff=deripple_coeff, temporal_taper=temporal_taper,
        spectral_taper=spectral_taper, combine=combine, monotonic=monotonic,
        spectral_filter=spectral_filter,
    )
    consts = [None if c[k] is None else torch.as_tensor(c[k], device=z.device)
              for k in ("t_taper", "dr", "perm", "elem")]
    out = inversion_core(z.transpose(1, 2), *consts, geom, spans_nyquist=spans_nyquist)
    return cfft.same_kind(out, pair)
