"""FFT taper/window library used by the PFB inversion.

The port's copy of :mod:`ska_pst_dsp_tpu.utils.windows`, the equivalent of
the reference's PFBWindow.m:1-115 and the external ``pfb.fft_windows``
module. Windows are returned as plain NumPy float32 vectors that the
synthesis kernels take as constant tables.

The registry maps the same names the reference accepts (``no_window``,
``tukey``, ``hann``, ``top_hat``, plus the unregistered ``fedora`` and
``blackman`` factories) to window builders.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def _hann(n: int) -> np.ndarray:
    """Symmetric Hann window, matching Matlab ``hann(n)``
    (w[k] = 0.5*(1-cos(2*pi*k/(n-1))))."""
    if n == 1:
        return np.ones(1)
    k = np.arange(n)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * k / (n - 1)))


def no_window(fft_length: int, overlap: int) -> np.ndarray:
    """Identity taper (PFBWindow.m:18-23)."""
    return np.ones(fft_length, dtype=np.float32)


def tukey_window(fft_length: int, overlap: int) -> np.ndarray:
    """Flat top with Hann-shaped edges over the 2*overlap discard regions
    (PFBWindow.m:26-42)."""
    w = np.ones(fft_length)
    if overlap > 0:
        h = _hann(2 * overlap)
        w[:overlap] = h[:overlap]
        w[fft_length - overlap:] = h[overlap:]
    return w.astype(np.float32)


def top_hat_window(fft_length: int, overlap: int) -> np.ndarray:
    """Zero the overlap edges outright (PFBWindow.m:59-66)."""
    w = np.ones(fft_length)
    w[:overlap] = 0.0
    w[fft_length - overlap:] = 0.0
    return w.astype(np.float32)


def fedora_window(fft_length: int, overlap: int, fraction: float = 2.0) -> np.ndarray:
    """Zero a ``overlap/fraction``-wide edge region (PFBWindow.m:45-57)."""
    if fraction == 0:
        return np.ones(fft_length, dtype=np.float32)
    discard = int(round(overlap / fraction))
    return top_hat_window(fft_length, discard)


def hann_window(fft_length: int, overlap: int) -> np.ndarray:
    """Full-length Hann rotated so its peak sits at index 0 — the form the
    reference applies to the assembled spectrum (PFBWindow.m:68-100: hann of
    the data length, circshifted by ndat/2)."""
    return np.roll(_hann(fft_length), fft_length // 2).astype(np.float32)


def blackman_window(fft_length: int, overlap: int) -> np.ndarray:
    """Symmetric Blackman window (PFBWindow.m:102-113)."""
    if fft_length == 1:
        return np.ones(1, dtype=np.float32)
    k = np.arange(fft_length)
    x = 2.0 * np.pi * k / (fft_length - 1)
    return (0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2 * x)).astype(np.float32)


WINDOW_REGISTRY: Dict[str, Callable[[int, int], np.ndarray]] = {
    "no_window": no_window,
    "tukey": tukey_window,
    "hann": hann_window,
    "top_hat": top_hat_window,
    "fedora": fedora_window,
    "blackman": blackman_window,
}


def lookup(name: str) -> Callable[[int, int], np.ndarray]:
    """Window builder by name — same lookup surface as PFBWindow().lookup."""
    try:
        return WINDOW_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown window {name!r}; available: {sorted(WINDOW_REGISTRY)}"
        ) from None


def build(name: str, fft_length: int, overlap: int) -> np.ndarray:
    return lookup(name)(fft_length, overlap)
