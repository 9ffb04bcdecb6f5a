"""Spurious-power metrics.

The port's copy of the metrics of :mod:`ska_pst_dsp_tpu.verify.util`
(without its plots): the equivalent of python/verify/util.py:15-50 and
DomainPerformance.m:6-97.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "spurious",
    "total_spurious",
    "mean_spurious",
    "max_spurious",
    "dB",
    "DomainPerformance",
]


def spurious(a: np.ndarray) -> np.ndarray:
    """Zero the peak bin — what's left is spurious response (util.py:15-18)."""
    b = a.copy()
    b[np.argmax(b)] = 0.0
    return b


def dB(a) -> np.ndarray:
    """Power → dB with the reference's 1e-13 floor (util.py:39-43)."""
    return 10.0 * np.log10(np.abs(np.copy(a)) + 1e-13)


def total_spurious(a) -> float:
    return float(dB(np.sum(spurious(np.abs(a) ** 2))))


def mean_spurious(a) -> float:
    return float(dB(np.mean(spurious(np.abs(a) ** 2))))


def max_spurious(a) -> float:
    return float(dB(np.amax(spurious(np.abs(a) ** 2))))


class DomainPerformance:
    """Temporal/spectral performance measures (DomainPerformance.m:6-97):
    max/sum/mean |a-b|^2 differences and spurious power with a +-guard
    region zeroed around the peak."""

    def __init__(self, guard: int = 1):
        self.guard = guard

    def temporal_difference(self, a, b):
        n = min(a.size, b.size)
        d = np.abs(np.asarray(a).ravel()[:n] - np.asarray(b).ravel()[:n]) ** 2
        return {"max": float(d.max()), "sum": float(d.sum()), "mean": float(d.mean())}

    def _spurious_guarded(self, p: np.ndarray):
        peak = int(np.argmax(p))
        masked = p.copy()
        lo = max(0, peak - self.guard)
        masked[lo: peak + self.guard + 1] = 0.0
        return masked, p[peak]

    def temporal_performance(self, a):
        p = np.abs(np.asarray(a).ravel()) ** 2
        masked, peak = self._spurious_guarded(p)
        return {
            "max_spurious": float(dB(masked.max() / peak)),
            "total_spurious": float(dB(masked.sum() / peak)),
        }

    def spectral_performance(self, a, nfft: Optional[int] = None):
        a = np.asarray(a).ravel()
        if nfft is None:
            nfft = a.size
        spec = np.fft.fft(a[:nfft]) / nfft
        return self.temporal_performance(spec)
