"""Prototype FIR filter design for the oversampled PFB.

Native equivalents of the reference's Matlab filter designers:

* :func:`design_pfb_fir_filter` — single-stage least-squares lowpass
  (design_PFB_FIR_filter.m:34-52): band edges Fp=1/n_chan,
  Fst=(2*OS-1)/n_chan, stopband weight 15, order n_chan*taps_per_chan.
* :func:`design_pfb_fir_filter_two_stage` — spectral zero-stuffing design for
  very long filters (design_PFB_FIR_filter_two_stage.m:44-78): design a short
  stage-1 filter at scaled band edges, then Fourier-interpolate it by
  zero-stuffing its spectrum.
* :func:`design_pfb_fir_filter_alt` — overlap-save-optimized constrained
  design (design_PFB_FIR_filter_alt.m:47-66) through :func:`fircls1`, a
  native Matlab-``fircls1`` equivalent (iteratively reweighted
  constrained least squares), plus the same interpft/centering
  post-processing.
* :func:`generate_maxflat` / :func:`design_pfb_fir_filter_lowcbf` — the
  LowCBF firmware maximally-flat design (generate_MaxFlt.m:40-70,
  design_PFB_FIR_filter_lowcbf.m:9-11): Herrmann maximally-flat FIR starting
  point, 10 rounds of power-complementarity flattening, Fourier
  interpolation to n_chan*n_taps, optional 2^17 quantization.

All designs run in float64 NumPy/SciPy on the host — filter design is a
one-time offline step; only the resulting coefficient vector reaches the
card. This is the port's copy of :mod:`ska_pst_dsp_tpu.design.fir`: the
same designers give every config the same coefficients.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import scipy.signal

from ..utils.rational import Rational


# ---------------------------------------------------------------------------
# Fourier helpers
# ---------------------------------------------------------------------------

def interpft(x: np.ndarray, n_out: int) -> np.ndarray:
    """Fourier-domain interpolation/decimation, matching Matlab ``interpft``:
    resample a length-N sequence to n_out points via spectral zero-padding
    (or truncation), preserving the DC-anchored sample grid."""
    x = np.asarray(x, dtype=np.float64)
    n_in = x.size
    if n_out < n_in:
        # matlab decimates by interpolating to incr*n_out > n_in points and
        # taking every incr-th sample (interpft.m: incr = floor(m/ny)+1)
        incr = n_in // n_out + 1
        return interpft(x, incr * n_out)[::incr]
    X = np.fft.fft(x)
    half = (n_in + 1) // 2
    Y = np.zeros(n_out, dtype=complex)
    Y[:half] = X[:half]
    Y[n_out - (n_in - half):] = X[half:]
    if n_in % 2 == 0 and n_out > n_in:
        # split the Nyquist bin symmetrically
        Y[n_in // 2] = X[n_in // 2] / 2.0
        Y[n_out - n_in // 2] = X[n_in // 2] / 2.0
    y = np.fft.ifft(Y) * (n_out / n_in)
    return np.real(y)


def freqz_mag(h: np.ndarray, n_points: int) -> np.ndarray:
    """|H(e^{j w})| at n_points frequencies on [0, pi) — Matlab
    ``abs(freqz(h, 1, n))`` via a zero-padded FFT."""
    h = np.asarray(h, dtype=np.float64).ravel()
    n_fft = 2 * n_points
    if n_fft < h.size:
        # spectral wrapping form of the DFT at the requested resolution
        n_wrap = int(np.ceil(h.size / n_fft)) * n_fft
        hp = np.zeros(n_wrap)
        hp[: h.size] = h
        H = np.fft.fft(hp.reshape(-1, n_fft).sum(axis=0))
    else:
        H = np.fft.fft(h, n_fft)
    return np.abs(H[:n_points])


# ---------------------------------------------------------------------------
# Designers
# ---------------------------------------------------------------------------

def _firls(numtaps, bands, desired, weight):
    """Least-squares linear-phase FIR design for any length. SciPy's firls
    only handles odd numtaps (type I); Matlab's firls also designs even
    lengths (type II, h[n] = h[N-1-n], amplitude
    A(w) = 2*sum_k b_k cos(w(k+1/2))) — solved here on a dense grid."""
    if numtaps % 2 == 1:
        return scipy.signal.firls(numtaps, bands, desired, weight=weight)
    half = numtaps // 2
    n_grid = max(16 * numtaps, 2048)
    w_list, d_list, wt_list = [], [], []
    for i in range(0, len(bands), 2):
        f0, f1 = bands[i], bands[i + 1]
        npts = max(int(round((f1 - f0) * n_grid)), 8)
        f = np.linspace(f0, f1, npts)
        d = np.linspace(desired[i], desired[i + 1], npts)
        w_list.append(f)
        d_list.append(d)
        wt_list.append(np.full(npts, np.sqrt(weight[i // 2])))
    f = np.concatenate(w_list)
    d = np.concatenate(d_list)
    wt = np.concatenate(wt_list)
    # amplitude basis: 2*cos(pi*f*(k+1/2)), k = 0..half-1
    A = 2.0 * np.cos(np.pi * np.outer(f, np.arange(half) + 0.5))
    b, *_ = np.linalg.lstsq(A * wt[:, None], d * wt, rcond=None)
    return np.concatenate([b[::-1], b])


def fircls1(
    n: int,
    wo: float,
    dp: float,
    ds: float,
    wt: Optional[float] = None,
    *,
    max_iter: int = 400,
    tol: float = 1e-3,
) -> np.ndarray:
    """Constrained least-squares linear-phase lowpass — Matlab ``fircls1``
    semantics: length n+1, cutoff ``wo`` (normalized, Nyquist = 1), max
    passband deviation ``dp``, max stopband deviation ``ds``; with ``wt``
    given (lowpass case), the error above ``wt`` is constraint-weighted.

    Solved by iteratively reweighted least squares (Lawson-style
    multiplicative updates): a dense-grid weighted LS amplitude fit whose
    per-point weights grow wherever the ripple bound is violated, with an
    outer pass re-targeting the bounds by the measured overshoot. For
    feasible specs the interior ripples meet the bounds; the extremum
    hugging the transition edge can overshoot by a few percent (verified
    in tests/test_fir_design.py). Infeasible specs (as the reference's own
    alt design is at its order) return the balanced best-effort iterate —
    equalized violation ratios across bands."""
    numtaps = n + 1
    half = (numtaps + 1) // 2
    odd = numtaps % 2 == 1
    n_grid = max(64 * numtaps, 8192)
    f = np.linspace(0.0, 1.0, n_grid)
    # the CLS formulation measures ripple away from the band edge: exclude
    # one mainlobe width (~4/numtaps) around wo from the constraint set
    gap = 4.0 / numtaps
    pass_m = f <= wo
    stop_m = f >= wo + gap
    desired = np.where(pass_m, 1.0, 0.0)
    bound = np.where(pass_m, dp, ds)
    active = pass_m | stop_m
    # Matlab's wt (lowpass): error above wt is weighted harder
    base_w = np.ones(n_grid)
    if wt is not None:
        base_w[f >= wt] = 10.0

    if odd:
        # type I amplitude basis: cos(pi*f*k)
        A = np.cos(np.pi * np.outer(f, np.arange(half)))
        A[:, 1:] *= 2.0
    else:
        A = 2.0 * np.cos(np.pi * np.outer(f, np.arange(half) + 0.5))

    best = None
    shrink = 1.0
    for _outer in range(6):
        # the Lawson fixed point lands a few % above the bound; each outer
        # pass re-targets the internal bound by the measured overshoot
        bound_eff = bound / shrink
        w_iter = base_w.copy()
        inner_best = None
        for _ in range(max_iter):
            wv = np.where(active, w_iter, 0.0)
            sw = np.sqrt(wv)
            b, *_ = np.linalg.lstsq(
                A * sw[:, None], desired * sw, rcond=None
            )
            err = np.abs(A @ b - desired)
            viol = np.where(active, err / bound, 0.0)
            worst = viol.max()
            if inner_best is None or worst < inner_best[0]:
                inner_best = (worst, b)
            if worst <= 1.0 + tol:
                break
            # multiplicative reweighting on the violating points; max-
            # normalized to stay overflow-free over many iterations
            v_eff = np.where(active, err / bound_eff, 0.0)
            w_iter = w_iter * np.maximum(v_eff, 1.0)
            w_iter = np.maximum(w_iter / w_iter.max(), 1e-12)
        improved = best is None or inner_best[0] < best[0] * 0.999
        if best is None or inner_best[0] < best[0]:
            best = inner_best
        if best[0] <= 1.0 + tol or (not improved and _outer > 0):
            break
        shrink *= inner_best[0]
    b = best[1]
    if odd:
        # A[:,0]=1, A[:,k>=1]=2cos(pi f k) => h[c]=b0, h[c+-k]=b_k
        h = np.concatenate([b[:0:-1], b])
    else:
        h = np.concatenate([b[::-1], b])
    return h


def design_pfb_fir_filter(
    n_chan: int,
    os_factor: Rational,
    n_taps_per_chan: int = 12,
    stopband_weight: float = 15.0,
) -> np.ndarray:
    """Single-stage least-squares prototype lowpass
    (design_PFB_FIR_filter.m:34-48). Returns n_chan*n_taps_per_chan + 1
    coefficients (filter order n_chan*n_taps_per_chan)."""
    os_factor = Rational.coerce(os_factor)
    os = float(os_factor)
    if os == 1.0:
        os += 0.1
    f_pass = 1.0 / n_chan
    f_stop = (2.0 * os - 1.0) / n_chan
    order = n_chan * n_taps_per_chan
    h = scipy.signal.firls(
        order + 1,
        [0.0, f_pass, f_stop, 1.0],
        [1.0, 1.0, 0.0, 0.0],
        weight=[1.0, stopband_weight],
    )
    return h.astype(np.float64)


def design_pfb_fir_filter_two_stage(
    n_chan: int,
    os_factor: Rational,
    os_taps_per_chan: int = 28,
    zero_stuff_factor: Optional[int] = None,
    stopband_weight: float = 15.0,
) -> np.ndarray:
    """Two-stage spectral zero-stuffing design for >1e5-tap filters
    (design_PFB_FIR_filter_two_stage.m:44-78)."""
    os_factor = Rational.coerce(os_factor)
    os = float(os_factor)
    if zero_stuff_factor is None:
        zero_stuff_factor = (os_taps_per_chan * os_factor.nu) // os_factor.de

    n_taps = int(os_taps_per_chan * n_chan / os)
    n_taps_stage1 = n_taps // zero_stuff_factor

    f_pass = 1.0 / n_chan
    f_stop = (2.0 * os - 1.0) / n_chan
    h0 = _firls(
        n_taps_stage1 + 1,
        [0.0, f_pass * zero_stuff_factor, 0.998 * f_stop * zero_stuff_factor, 1.0],
        [1.0, 1.0, 0.0, 0.0],
        weight=[1.0, stopband_weight],
    )

    # stage 2: zero-stuff the stage-1 spectrum by zero_stuff_factor
    # (inserting zeros between spectral halves Fourier-interpolates the
    # impulse response to n_taps+1 coefficients)
    H1 = np.fft.fft(np.fft.ifftshift(h0))
    lo = H1[: n_taps_stage1 // 2 + 1]
    hi = H1[n_taps_stage1 // 2 + 1:]
    HZ = np.concatenate([lo, np.zeros(n_taps_stage1 * (zero_stuff_factor - 1)), hi])
    h = np.fft.fftshift(np.real(np.fft.ifft(HZ)))
    return h.astype(np.float64)


def design_pfb_fir_filter_alt(
    n_chan: int,
    os_factor: Rational,
    n_taps_per_chan: int = 12,
    dp: float = 1e-3,
    ds: float = 1e-4,
) -> np.ndarray:
    """Overlap-save-optimized design (design_PFB_FIR_filter_alt.m:47-66):
    ``fircls1`` (constrained least squares, dp=1e-3, ds=-80 dB) at the
    reference's band edges (fudge_stop=1.3), Fourier-interpolated to
    n_taps, normalized to unit DC gain, and centered by
    oversampled_ntaps_per_chan/2 (AT3-150). As in the reference, the alt
    band edges cannot actually meet dp/ds at this order — the constrained
    solver returns its best-effort iterate (see :func:`fircls1`)."""
    os_factor = Rational.coerce(os_factor)
    os = float(os_factor)
    if n_taps_per_chan > os_factor.de:
        fscale = 1
        os_ntaps_per_chan = (n_taps_per_chan * os_factor.nu) // os_factor.de
    else:
        fscale = n_taps_per_chan
        os_ntaps_per_chan = os_factor.nu
        n_taps_per_chan = n_taps_per_chan * os_factor.de

    n = os_ntaps_per_chan * n_taps_per_chan - 1
    n_taps = n_taps_per_chan * n_chan

    wo = fscale / n_taps_per_chan
    wt = 1.3 * (2 * os - 1) * fscale / n_taps_per_chan
    c = fircls1(n, wo, dp, ds, min(wt, 0.999))
    h = interpft(c, n_taps)
    h = h / h.sum()
    h = np.roll(h, os_ntaps_per_chan // 2)
    return h.astype(np.float64)


def _herrmann_maxflat(order: int, w_cut: float) -> np.ndarray:
    """Symmetric maximally-flat FIR lowpass (Matlab ``maxflat(n,'sym',Wn)``
    equivalent): from the Herrmann family
    H(w) = cos^{2K}(w/2) * sum_{m<M} C(K-1+m, m) sin^{2m}(w/2)
    with K+M = order/2 + 1 - ... chosen so the half-power point tracks w_cut."""
    if order % 2:
        raise ValueError("maxflat 'sym' requires even order")
    total = order // 2 + 1  # K + M; support = 2(K+M-1)+1 = order+1 taps
    n_fft = 8192
    w = 2.0 * np.pi * np.arange(n_fft) / n_fft
    s2 = np.sin(w / 2.0) ** 2
    best = None
    for K in range(1, total):
        M = total - K
        poly = np.zeros_like(w)
        for m in range(M):
            poly += math.comb(K - 1 + m, m) * s2**m
        H = np.cos(w / 2.0) ** (2 * K) * poly
        # -6 dB (half-magnitude) cutoff of the amplitude response, matching
        # matlab maxflat's Wn semantics
        half_band = H[: n_fft // 2]
        idx = np.argmin(np.abs(half_band - 0.5))
        err = abs(w[idx] / np.pi - w_cut)
        if best is None or err < best[0]:
            best = (err, H)
    H = best[1]
    # H is a trig polynomial of degree order/2 sampled on the full circle
    # (automatically symmetric, H(2pi-w)=H(w)); its IFFT gives the exact
    # zero-phase taps: h[0] at index 0, negative lags wrapped at the end.
    h = np.real(np.fft.ifft(H))
    half = order // 2
    taps = np.concatenate([h[-half:], h[: half + 1]])
    return taps / taps.sum()


def generate_maxflat(nbuff: int = 256, n_tap: int = 12) -> np.ndarray:
    """LowCBF firmware prototype filter (generate_MaxFlt.m:40-70): start from
    a 2*n_tap-order maximally flat FIR, run 10 rounds of power-complementarity
    flattening (total power of a tone across the 2-channel split held
    constant), then Fourier-interpolate to nbuff*n_tap taps.

    Fidelity note: the taps this produces correlate ~0.9 with the vendored
    firmware coefficients (config/PST_filtertaps.txt). The real firmware file
    was generated by a newer generate_MaxFlt revision whose core filter has
    length 96 (spectral support ±48 in the 3072-tap file — the published
    generate_MaxFlt.m can only produce ±12), so it is not reproducible from
    the reference's own source. Bit-exact firmware modelling therefore uses
    the vendored tap file directly (the ``lowpsi`` config); this designer is
    the documented stand-in for regenerating approximate coefficients."""
    n_tap2 = 2 * n_tap
    imp = _herrmann_maxflat(n_tap2, 0.5 * n_tap2 / (n_tap2 + 1))
    imp = interpft(imp, n_tap2) * (n_tap2 + 1) / n_tap2

    for _ in range(10):
        impf = np.fft.fft(imp)
        imph = imp * np.cos(np.arange(imp.size) * np.pi)
        impfh = np.fft.fft(imph)
        errorf = np.abs(impf) ** 2 + np.abs(impfh) ** 2
        errorf = 1.0 - errorf / errorf[0]
        error = np.fft.fftshift(np.real(np.fft.ifft(errorf)))
        imp = imp + error / 2.0

    return interpft(imp, nbuff * n_tap)


def design_pfb_fir_filter_lowcbf(
    quantize: bool = True, n_chan: int = 256, n_tap: int = 12
) -> np.ndarray:
    """LowCBF design wrapper (design_PFB_FIR_filter_lowcbf.m:9-15): maxflat
    taps, optionally quantized to 2^17 integer levels like the firmware, then
    normalized to unit sum."""
    h = generate_maxflat(n_chan, n_tap)
    if quantize:
        h = np.round(2.0**17 * h)
    return h / h.sum()


# ---------------------------------------------------------------------------
# Deripple response
# ---------------------------------------------------------------------------

def deripple_response(
    filter_coeff: np.ndarray, n_chan: int, passband_half_width: int
) -> np.ndarray:
    """Per-fine-channel passband equalization vector of length
    2*passband_half_width (polyphase_synthesis.m:138-150): the reciprocal
    baseband magnitude response of the prototype filter, mirrored across each
    channel's two halves."""
    mag = freqz_mag(filter_coeff, n_chan * passband_half_width)
    inv = 1.0 / mag[: passband_half_width + 1]
    vec = np.empty(2 * passband_half_width, dtype=np.float64)
    # first half: inv[pb], inv[pb-1], ..., inv[1]; second half: inv[0..pb-1]
    vec[:passband_half_width] = inv[passband_half_width:0:-1]
    vec[passband_half_width:] = inv[:passband_half_width]
    return vec


# ---------------------------------------------------------------------------
# Coefficient file handling (read_fir_filter_coeff.m equivalent)
# ---------------------------------------------------------------------------

def read_fir_filter_coeff(path: str) -> np.ndarray:
    """Load coefficients from .npy/.npz (fields ``h`` or ``hQ``) or plain
    text (e.g. firmware tap listings)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            for key in ("hQ", "h"):
                if key in z:
                    return np.asarray(z[key], dtype=np.float64).ravel()
            raise KeyError(f"{path} has neither 'h' nor 'hQ'")
    if path.endswith(".npy"):
        return np.asarray(np.load(path), dtype=np.float64).ravel()
    return np.loadtxt(path, dtype=np.float64).ravel()


_DESIGNERS = {
    # filename fragment → designer
    "Prototype_FIR.new": lambda cfg: design_pfb_fir_filter(
        cfg.channels, cfg.os_factor, _taps_per_chan(cfg)
    ),
    "Prototype_FIR.2_stage": lambda cfg: design_pfb_fir_filter_two_stage(
        cfg.channels, cfg.os_factor
    ),
    "Prototype_FIR.alt": lambda cfg: design_pfb_fir_filter_alt(
        cfg.channels, cfg.os_factor, _taps_per_chan(cfg)
    ),
    "PST_filtertaps": lambda cfg: design_pfb_fir_filter_lowcbf(True),
    "Prototype_FIR.lowcbf": lambda cfg: design_pfb_fir_filter_lowcbf(False),
}


def _taps_per_chan(cfg) -> int:
    return max(1, round(cfg.fir_filter_taps / cfg.channels))


def load_or_design(cfg) -> np.ndarray:
    """Load a config's FIR coefficients, designing and caching them on first
    use (the reference ships .mat files; we regenerate deterministically)."""
    path = cfg.fir_filter_path
    if os.path.exists(path):
        return read_fir_filter_coeff(path)
    for fragment, designer in _DESIGNERS.items():
        if fragment in os.path.basename(path):
            h = designer(cfg)
            np.save(path if path.endswith(".npy") else path + ".npy", h)
            if not path.endswith(".npy"):
                # also store under the configured name for future loads
                np.savetxt(path, h) if path.endswith(".txt") else np.savez(
                    path if path.endswith(".npz") else path + ".npz", h=h
                )
            return h
    raise FileNotFoundError(
        f"no coefficients at {path} and no designer matches its name"
    )


def recenter_coefficients(h: np.ndarray, target_taps: Optional[int] = None) -> np.ndarray:
    """Extract the symmetric center of an externally supplied coefficient
    set (recenter_mid_coefficients.m:20-40: NRC-delivered hQ arrays carry
    asymmetric padding; keep the window centered on the peak)."""
    h = np.asarray(h, dtype=np.float64).ravel()
    if target_taps is None or target_taps >= h.size:
        return h
    center = int(np.argmax(np.abs(h)))
    half = target_taps // 2
    lo = max(0, center - half)
    hi = lo + target_taps
    if hi > h.size:
        hi = h.size
        lo = hi - target_taps
    return h[lo:hi].copy()
