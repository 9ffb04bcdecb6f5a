"""NumPy golden oracle for the PFB round trip.

The port's copy of :mod:`ska_pst_dsp_tpu.oracle`: loop-faithful NumPy
renditions of the reference Matlab math, float64 by default, that the
port's chain is held to on the card (``chip_smoke.py``). It holds the
critically sampled and zero-padded analyses, the LowCBF firmware filterbank
(:func:`pst_filterbank` and its wrapper :func:`polyphase_analysis_lowcbf`)
and the synthesis. They favour clarity over speed: per-block Python loops.
The LowCBF model shares no code with :mod:`.ops.lowcbf`, the kernel route
it is the reference for.

Math sources in the reference (cited for parity checking, not copied):
polyphase_analysis.m:56-120, polyphase_analysis_padded.m:61-156,
polyphase_synthesis.m:112-316, PSTFilterbank.m:7-45,
polyphase_analysis_lowcbf.m:16-48.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .utils.rational import Rational
from .utils import geometry


def _pad_filter(filt: np.ndarray, n_chan: int) -> np.ndarray:
    out = np.zeros(geometry.padded_filter_length(filt.size, n_chan), dtype=filt.dtype)
    out[: filt.size] = filt
    return out


def polyphase_analysis(
    in_pft: np.ndarray,
    filt: np.ndarray,
    block: int,
    os_factor: Rational,
) -> np.ndarray:
    """Single-stage oversampled analysis PFB (Bunton / SKA-Low style).

    Per output step k: window the next padded-filter-length samples with the
    prototype filter, cyclic-shift by (step*k mod block) to cancel the
    spectrum rotation caused by the fractional (oversampled) hop, fold the
    phases, and take a conjugated, block^2-scaled inverse DFT (upper-sideband
    convention, AT3-235). See polyphase_analysis.m:88-120.

    in_pft: (n_pol, 1, n_dat) complex. Returns (n_pol, block, nblocks).
    """
    os_factor = Rational.coerce(os_factor)
    n_pol, _, n_dat = in_pft.shape
    dtype = in_pft.dtype
    filt = filt.astype(np.float32 if dtype == np.complex64 else np.float64)

    step = geometry.analysis_step(block, os_factor)
    f = _pad_filter(filt, block)
    fl = f.size
    phases = fl // block
    nblocks = (n_dat - fl) // step

    out = np.zeros((n_pol, block, nblocks), dtype=dtype)
    for ip in range(n_pol):
        x = in_pft[ip, 0]
        for k in range(nblocks):
            windowed = f * x[k * step: k * step + fl]
            shift = (step * k) % block
            shifted = np.roll(np.conj(windowed), shift)
            folded = shifted.reshape(phases, block).sum(axis=0)
            out[ip, :, k] = np.conj(np.fft.ifft(folded) * block * block)
    return out


def polyphase_analysis_padded(
    in_pft: np.ndarray,
    filt: np.ndarray,
    block: int,
    os_factor: Rational,
) -> np.ndarray:
    """Zero-padded analysis PFB (Gunaratne / SKA-Mid style).

    Maintains a sliding 2-D mask of the newest padded-filter-length samples
    in time-reversed order, takes the polyphase dot product per output step,
    barrel-rotates by -( (nu-BRI)*overlap mod block ), and applies a
    block^2-scaled inverse DFT (lower sideband); the whole output is finally
    advanced by sample_delay_shift = ceil((taps-1)/2/step) to cancel the
    filter group delay. See polyphase_analysis_padded.m:61-156.
    """
    os_factor = Rational.coerce(os_factor)
    n_pol, _, n_dat = in_pft.shape
    dtype = in_pft.dtype

    step = geometry.analysis_step(block, os_factor)
    overlap = block - step
    nblocks = n_dat // step
    delay = geometry.padded_sample_delay_shift(filt.size, block, os_factor)

    f = _pad_filter(filt.astype(np.float64), block)
    fl = f.size
    phases = fl // block
    # f2d[j, m] = f[j + m*block]  (column-major reshape)
    f2d = f.reshape(phases, block).T

    out = np.zeros((n_pol, block, nblocks), dtype=np.complex128)
    for ip in range(n_pol):
        x = in_pft[ip, 0]
        mask = np.zeros(fl, dtype=np.complex128)
        bri = 0
        for idx in range(1, nblocks + 1):
            y = (f2d * mask.reshape(phases, block).T).sum(axis=1)
            if bri != 0:
                shift = ((os_factor.nu - bri) * overlap) % block
                y = np.roll(y, -shift)
            out[ip, :, idx - 1] = (block * block) * np.fft.ifft(y)
            # advance the mask: newest `step` samples enter time-flipped
            mask[step:] = mask[:-step].copy()
            mask[:step] = x[idx * step - 1: (idx - 1) * step - 1 if idx > 1 else None: -1]
            bri = (bri + 1) % os_factor.nu
    out = np.roll(out, -delay, axis=2)
    return out.astype(dtype)


def pst_filterbank(
    din: np.ndarray, fir_taps: np.ndarray, do_padding: bool
) -> np.ndarray:
    """LowCBF firmware filterbank model (PSTFilterbank.m:7-45): 3072-tap /
    256-channel / 12-tap FIR with hop 192, fftshifted forward FFT scaled by
    1/128, per-sample pi/2 phase de-rotation, channels 20..235 kept (216).

    din: (n_dat,) complex. Returns (216, n_out) complex128 with
    n_out = (n_dat + padding - 3072) // 192 (the last full window is not
    emitted) and padding = 1536 zeros when ``do_padding``; a stream shorter
    than one window less the padding raises ValueError."""
    nfilt, block, step = 3072, 256, 192
    padding = 1536 if do_padding else 0
    dinp = np.concatenate([np.zeros(padding, dtype=din.dtype), din])
    n_out = (dinp.size - nfilt) // step

    taps2d = fir_taps.reshape(12, block)  # taps2d[t, n1] = FIR[n1 + 256 t]
    out = np.zeros((216, n_out), dtype=np.complex128)
    quarter = np.array([1, 1j, -1, -1j])  # exp(2*pi*i*k/4), exact
    bins = np.arange(-128, 128)
    for s in range(n_out):
        seg = dinp[s * step: s * step + nfilt].reshape(12, block)
        fft_in = (taps2d * seg).sum(axis=0) / 2.0**9
        d1 = np.fft.fftshift(np.fft.fft(fft_in)) / 128.0
        rot = quarter[(s * (-bins)) % 4]
        out[:, s] = (d1 * rot)[20:236]
    return out


def polyphase_analysis_lowcbf(
    in_pft: np.ndarray,
    filt: np.ndarray,
    block: int,
    os_factor: Rational,
    first_call: bool = True,
) -> np.ndarray:
    """LowCBF wrapper (polyphase_analysis_lowcbf.m:16-48): PSTFilterbank per
    polarization, rescaled by 2^9*2048*256, zero-padded 1536 samples on the
    first call only (streaming state made explicit via ``first_call``).

    in_pft: (n_pol, 1, n_dat) complex. Returns (n_pol, 216, n_out) in
    in_pft's dtype: feed complex128 for an fp64 reference. ``block`` and
    ``os_factor`` are accepted for the analysis functions' common signature;
    the firmware geometry is fixed."""
    scale = 2.0**9 * 2048 * 256
    n_pol = in_pft.shape[0]
    outs = []
    for ip in range(n_pol):
        outs.append(pst_filterbank(in_pft[ip, 0], filt, first_call) * scale)
    return np.stack(outs, axis=0).astype(in_pft.dtype)


def polyphase_synthesis(
    in_pft: np.ndarray,
    input_fft_length: int,
    os_factor: Rational,
    *,
    spans_nyquist: bool = True,
    input_overlap: Optional[int] = None,
    deripple_coeff: Optional[np.ndarray] = None,
    sample_offset: int = 0,
    temporal_taper: Optional[np.ndarray] = None,
    spectral_taper: Optional[np.ndarray] = None,
    combine: int = 1,
) -> np.ndarray:
    """Golden FFT-based PFB inversion (polyphase_synthesis.m:112-316).

    Overlap-save over fine-channel spectra: per block and polarization,
    temporally taper, forward-FFT each channel, fftshift, keep the central
    FN_width passband bins, optionally deripple, assemble the full-band
    spectrum (with the DC-centered split of channel 0 when the input spans
    the full Nyquist zone), spectrally taper, inverse-FFT, and discard the
    output overlap on both sides.

    in_pft: (n_pol, n_chan, n_dat) fine-channel data. Returns
    (n_pol, 1, n_blocks*output_keep).
    """
    os_factor = Rational.coerce(os_factor)
    if sample_offset:
        in_pft = in_pft[:, :, sample_offset:]
    n_pol, n_chan, n_dat = in_pft.shape
    dtype = in_pft.dtype
    L = input_fft_length
    if input_overlap is None:
        input_overlap = L // 8
    geom = geometry.SynthesisGeometry(n_chan, L, input_overlap, os_factor)
    n_blocks = geom.n_blocks(n_dat)
    fnw = geom.fn_width
    fnw2 = fnw // 2
    discard = geom.discard

    if deripple_coeff is not None:
        from .design.fir import deripple_response

        dr = deripple_response(deripple_coeff, n_chan, fnw2)
    else:
        dr = None

    # combine>1: fine channels span `combine` coarse channels; re-order
    # input channels DSB-monotonically (polyphase_synthesis.m:198-238)
    jchan = np.arange(n_chan)
    if combine > 1:
        fcpc = n_chan // combine
        fine = (jchan + fcpc // 2) % n_chan
        coarse = fine // fcpc
        fine = fine - coarse * fcpc
        coarse = (coarse + combine // 2) % combine
        fine = (fine + fcpc // 2) % fcpc
        jchan = coarse * fcpc + fine

    out = np.zeros((n_pol, 1, n_blocks * geom.output_keep), dtype=dtype)
    for b in range(n_blocks):
        s = b * geom.input_keep
        chunk = in_pft[:, :, s: s + L].astype(np.complex128)
        if temporal_taper is not None:
            chunk = chunk * temporal_taper[None, None, :]
        spectra = np.fft.fftshift(np.fft.fft(chunk, axis=-1), axes=-1)
        fn = spectra[:, jchan, discard: discard + fnw]
        if dr is not None:
            fn = fn * dr[None, None, :]
        flat = fn.reshape(n_pol, n_chan * fnw)
        if spans_nyquist:
            flat = np.roll(flat, -fnw2, axis=-1)
        if spectral_taper is not None:
            flat = flat * spectral_taper[None, :]
        big = np.fft.ifft(flat, axis=-1) * (os_factor.de / os_factor.nu)
        kept = big[:, geom.output_overlap: geom.output_fft_length - geom.output_overlap]
        out[:, 0, b * geom.output_keep: (b + 1) * geom.output_keep] = kept
    return out
