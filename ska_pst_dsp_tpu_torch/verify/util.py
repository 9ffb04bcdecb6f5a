"""Spurious-power metrics and comparison plots.

The port's copy of :mod:`ska_pst_dsp_tpu.verify.util`: the equivalent of
python/verify/util.py:15-145 and DomainPerformance.m:6-97. matplotlib is
imported when a plot is drawn, not with the module.
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
    "plot_time_domain_comparison",
    "plot_freq_domain_comparison",
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


def _default_labels(labels, n=2):
    return labels or [f"array {i + 1}" for i in range(n)]


def _pyplot():
    """matplotlib.pyplot on the Agg backend (ImportError without matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_time_domain_comparison(op_result, subplots_kwargs=None, labels=None):
    """Stacked real/imag + difference panels (util.py:52-100)."""
    plt = _pyplot()
    this = [v for _, v in op_result["this"].items()]
    diff = [v for _, v in op_result["diff"].items()]
    labels = _default_labels(labels, len(this))
    fig, axes = plt.subplots(len(this) + 1, 1, **(subplots_kwargs or {}))
    for ax, arr, label in zip(axes, this, labels):
        ax.plot(np.real(arr), label="re")
        ax.plot(np.imag(arr), label="im")
        ax.set_title(label)
        ax.legend()
    axes[-1].plot(np.abs(diff[0]))
    axes[-1].set_title("|difference|")
    return fig, axes


def plot_freq_domain_comparison(time_op_result, freq_op_result,
                                subplots_kwargs=None, labels=None):
    """Time series + power spectra + differences (util.py:103-145)."""
    plt = _pyplot()
    t_this = [v for _, v in time_op_result["this"].items()]
    f_this = [v for _, v in freq_op_result["this"].items()]
    f_diff = [v for _, v in freq_op_result["diff"].items()]
    labels = _default_labels(labels, len(t_this))
    rows = len(t_this) + len(f_this) + 1
    fig, axes = plt.subplots(rows, 1, **(subplots_kwargs or {}))
    i = 0
    for arr, label in zip(t_this, labels):
        axes[i].plot(np.real(arr))
        axes[i].plot(np.imag(arr))
        axes[i].set_title(f"{label} (time)")
        i += 1
    for arr, label in zip(f_this, labels):
        axes[i].plot(dB(np.abs(arr) ** 2))
        axes[i].set_title(f"{label} (power spectrum, dB)")
        i += 1
    axes[i].plot(dB(np.abs(f_diff[0]) ** 2))
    axes[i].set_title("spectrum |difference| (dB)")
    return fig, axes
