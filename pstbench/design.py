"""The prototype filters and the inversion's tables, designed by the benchmark.

Plain NumPy/SciPy copies of the reference designs (design_PFB_FIR_filter.m,
design_PFB_FIR_filter_two_stage.m, polyphase_synthesis.m's deripple,
PFBWindow.m's tukey), and a reader of published coefficient files. The
benchmark designs (or reads) each configuration's filter once per run and
hands the same coefficients to the program under test and to
:mod:`pstbench.reference`; the deripple and the taper are worked out again
by the reference from those coefficients alone.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import scipy.signal

#: the checkout's root, which a coefficient file's path is relative to
ROOT = Path(__file__).resolve().parent.parent


def os_parts(cfg: dict) -> Tuple[int, int]:
    """(nu, de) of the configuration's oversampling ratio ``"nu/de"``."""
    nu, de = (int(v) for v in str(cfg["os_factor"]).split("/"))
    return nu, de


def _firls(numtaps: int, bands, desired, weight) -> np.ndarray:
    """Least-squares linear-phase FIR of any length: SciPy's ``firls`` for
    odd lengths; for even lengths (type II) a dense-grid solve, as Matlab's
    ``firls`` designs them."""
    if numtaps % 2 == 1:
        return scipy.signal.firls(numtaps, bands, desired, weight=weight)
    half = numtaps // 2
    n_grid = max(16 * numtaps, 2048)
    fs, ds, ws = [], [], []
    for i in range(0, len(bands), 2):
        npts = max(int(round((bands[i + 1] - bands[i]) * n_grid)), 8)
        fs.append(np.linspace(bands[i], bands[i + 1], npts))
        ds.append(np.linspace(desired[i], desired[i + 1], npts))
        ws.append(np.full(npts, np.sqrt(weight[i // 2])))
    f, d, w = np.concatenate(fs), np.concatenate(ds), np.concatenate(ws)
    a = 2.0 * np.cos(np.pi * np.outer(f, np.arange(half) + 0.5))
    b, *_ = np.linalg.lstsq(a * w[:, None], d * w, rcond=None)
    return np.concatenate([b[::-1], b])


def least_squares(n_chan: int, nu: int, de: int, taps_per_channel: int,
                  stopband_weight: float) -> np.ndarray:
    """Single-stage least-squares lowpass of order n_chan * taps_per_channel
    (design_PFB_FIR_filter.m:34-48): pass to 1/n_chan, stop from
    (2*OS - 1)/n_chan."""
    os = nu / de
    if os == 1.0:
        os += 0.1
    return scipy.signal.firls(
        n_chan * taps_per_channel + 1,
        [0.0, 1.0 / n_chan, (2.0 * os - 1.0) / n_chan, 1.0],
        [1.0, 1.0, 0.0, 0.0], weight=[1.0, stopband_weight],
    ).astype(np.float64)


def two_stage(n_chan: int, nu: int, de: int, os_taps_per_channel: int,
              stopband_weight: float) -> np.ndarray:
    """Two-stage spectral zero-stuffing design
    (design_PFB_FIR_filter_two_stage.m:44-78): a short least-squares filter
    at band edges scaled by the zero-stuffing factor, its spectrum then
    zero-stuffed to n_taps + 1 coefficients."""
    os = nu / de
    stuff = (os_taps_per_channel * nu) // de
    n_taps = int(os_taps_per_channel * n_chan / os)
    n1 = n_taps // stuff
    f_pass, f_stop = 1.0 / n_chan, (2.0 * os - 1.0) / n_chan
    h0 = _firls(n1 + 1, [0.0, f_pass * stuff, 0.998 * f_stop * stuff, 1.0],
                [1.0, 1.0, 0.0, 0.0], [1.0, stopband_weight])
    h1 = np.fft.fft(np.fft.ifftshift(h0))
    hz = np.concatenate([h1[: n1 // 2 + 1], np.zeros(n1 * (stuff - 1)), h1[n1 // 2 + 1:]])
    return np.fft.fftshift(np.real(np.fft.ifft(hz))).astype(np.float64)


def coefficient_file(path: str, root: Path = ROOT) -> np.ndarray:
    """The taps of a published coefficient file, float64 and 1-D: a
    ``.npy`` file through ``np.load``, anything else as whitespace-separated
    numbers in the order written. ``path`` is relative to ``root``; one that
    leads outside it is refused, as are taps that are not finite."""
    root = Path(root).resolve()
    full = (root / path).resolve()
    if not full.is_relative_to(root):
        raise ValueError(f"coefficient file {path!r} lies outside {root}")
    if full.suffix == ".npy":
        h = np.asarray(np.load(full, allow_pickle=False), dtype=np.float64)
    else:
        h = np.array([float(v) for v in full.read_text().split()], dtype=np.float64)
    if h.ndim != 1 or not np.isfinite(h).all():
        raise ValueError(f"{path}: the taps are not one finite row (shape {h.shape})")
    return h


def prototype_filter(cfg: dict, root: Path = ROOT) -> np.ndarray:
    """The configuration's prototype filter, float64, as its ``filter``
    entry describes it: ``least_squares``, ``two_stage``, or ``file`` (the
    taps of ``path``, relative to ``root``: :func:`coefficient_file`);
    raises where the filter's length is not ``fir_filter_taps``."""
    spec = cfg["filter"]
    if spec["design"] == "file":
        h = coefficient_file(spec["path"], root)
    elif spec["design"] == "least_squares":
        h = least_squares(cfg["channels"], *os_parts(cfg), spec["taps_per_channel"],
                          spec["stopband_weight"])
    elif spec["design"] == "two_stage":
        h = two_stage(cfg["channels"], *os_parts(cfg), spec["os_taps_per_channel"],
                      spec["stopband_weight"])
    else:
        raise ValueError(f"unknown filter design {spec['design']!r}")
    if h.size != cfg["fir_filter_taps"]:
        raise ValueError(f"{cfg['name']}: the filter has {h.size} taps, "
                         f"not {cfg['fir_filter_taps']}")
    return h


def freqz_mag(h: np.ndarray, n_points: int) -> np.ndarray:
    """|H(e^{jw})| at n_points frequencies on [0, pi), Matlab's
    ``abs(freqz(h, 1, n))``, through a zero-padded (or wrapped) FFT."""
    n_fft = 2 * n_points
    if n_fft < h.size:
        wrap = np.zeros(-(-h.size // n_fft) * n_fft)
        wrap[: h.size] = h
        spec = np.fft.fft(wrap.reshape(-1, n_fft).sum(axis=0))
    else:
        spec = np.fft.fft(h, n_fft)
    return np.abs(spec[:n_points])


def deripple(h: np.ndarray, n_chan: int, half_width: int) -> np.ndarray:
    """The passband equalisation of each fine channel, length 2*half_width
    (polyphase_synthesis.m:138-150): the reciprocal of the filter's
    magnitude response, mirrored over the channel's two halves."""
    inv = 1.0 / freqz_mag(h, n_chan * half_width)[: half_width + 1]
    return np.concatenate([inv[half_width:0:-1], inv[:half_width]])


def taper(name: str, length: int, overlap: int) -> np.ndarray:
    """The inversion's temporal taper (PFBWindow.m): ``tukey`` (Hann edges
    over the two overlaps) or ``no_window``; float64."""
    w = np.ones(length)
    if name == "tukey" and overlap > 0:
        k = np.arange(2 * overlap)
        hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * k / (2 * overlap - 1)))
        w[:overlap] = hann[:overlap]
        w[length - overlap:] = hann[overlap:]
    elif name not in ("tukey", "no_window"):
        raise ValueError(f"unknown taper {name!r}")
    return w
