"""Quick-look and report plotting.

Equivalents of the reference's plotting layer: plot_purity_results.py
(purity-report JSON → spurious-power scatter), plots/plot_impulse.py
(impulse neighborhood in dB), plots/plot_tone.py (per-block tone spectra),
matlab/plot_FIR_filter.m (3-panel filter response with passband/OS/stopband
markers), matlab/critical_points.m, python/fft_impulse_response.py and
single_double_fft.py (fp32 vs fp64 FFT error study), matlab/bit_histogram.m.

All functions save PNGs (Agg backend) and return the figure. The port's
copy of :mod:`ska_pst_dsp_tpu.analysis.plots`, with one difference:
matplotlib is imported when a function draws, not with the module, so a
driver that imports this module runs where matplotlib is missing and loses
only its figures.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..io import dada
from ..verify.util import _pyplot, dB


def plot_purity_results(report_path: str, output_path: Optional[str] = None):
    """Purity-report JSON → scatter of max/total spurious power vs
    offset/frequency (plot_purity_results.py)."""
    plt = _pyplot()
    with open(report_path) as f:
        report = json.load(f)
    fig, axes = plt.subplots(len(report), 1, figsize=(10, 5 * len(report)),
                             squeeze=False)
    for ax_row, (method, entries) in zip(axes, report.items()):
        ax = ax_row[0]
        xs = [e["arg"] for e in entries]
        for key in ("max_spurious_power", "total_spurious_power",
                    "mean_spurious_power"):
            if entries and key in entries[0]:
                ax.plot(xs, [e[key] for e in entries], "o-", label=key)
        ax.axhline(-60, color="r", ls="--", label="-60 dB requirement")
        ax.set_title(method)
        ax.set_xlabel("offset / frequency")
        ax.set_ylabel("dB")
        ax.legend()
    fig.tight_layout()
    out = output_path or report_path.replace(".json", ".png")
    fig.savefig(out)
    return fig


def plot_impulse(dada_path: str, output_path: Optional[str] = None,
                 pol: int = 0, chan: int = 0, halfwidth: int = 2048):
    """Impulse neighborhood in dB (plots/plot_impulse.py)."""
    plt = _pyplot()
    data, _ = dada.load(dada_path)
    v = data[pol, chan]
    peak = int(np.abs(v).argmax())
    lo = max(0, peak - halfwidth)
    seg = v[lo: peak + halfwidth]
    fig, ax = plt.subplots(figsize=(10, 5))
    amp_db = 20 * np.log10(np.abs(seg) + 1e-30)
    ax.plot(np.arange(lo, lo + seg.size), amp_db - amp_db.max())
    ax.axhline(-60, color="r", ls="--")
    ax.set_xlabel("sample")
    ax.set_ylabel("dB rel. peak")
    ax.set_title(f"impulse at {peak}")
    fig.savefig(output_path or dada_path + ".impulse.png")
    return fig


def plot_tone(dada_path: str, output_path: Optional[str] = None,
              pol: int = 0, chan: int = 0, block_size: Optional[int] = None):
    """Tone spectrum per inversion block (plots/plot_tone.py)."""
    plt = _pyplot()
    data, header = dada.load(dada_path)
    v = data[pol, chan]
    if block_size is None:
        block_size = min(v.size, 1 << 16)
    nblk = max(1, v.size // block_size)
    fig, axes = plt.subplots(nblk, 1, figsize=(10, 3 * nblk), squeeze=False)
    for b in range(nblk):
        seg = v[b * block_size: (b + 1) * block_size]
        spec = dB(np.abs(np.fft.fft(seg) / seg.size) ** 2)
        axes[b][0].plot(spec - spec.max())
        axes[b][0].axhline(-60, color="r", ls="--")
        axes[b][0].set_title(f"block {b}")
    fig.tight_layout()
    fig.savefig(output_path or dada_path + ".tone.png")
    return fig


def plot_fir_filter(n_chan: int, os_factor: float, h: np.ndarray,
                    output_path: str = "fir_response.png"):
    """3-panel transfer function with passband / oversampled-band / stopband
    markers (plot_FIR_filter.m:1-62)."""
    plt = _pyplot()
    n_fft = max(1 << 18, 8 * h.size)
    H = np.abs(np.fft.fft(h, n_fft))[: n_fft // 2]
    H = H / H.max()
    f = np.linspace(0, 1, H.size)  # normalized to Nyquist
    fp = 1.0 / n_chan
    fs = (2 * os_factor - 1) / n_chan
    fig, axes = plt.subplots(3, 1, figsize=(10, 10))
    axes[0].plot(f, H)
    axes[0].set_xlim(0, 4 * fs)
    axes[0].set_title("transfer function")
    for ax in axes:
        ax.axvline(fp, color="g", ls="--", label="passband edge")
        ax.axvline(fs, color="r", ls="--", label="stopband edge")
    axes[1].plot(f, 20 * np.log10(H + 1e-300))
    axes[1].set_xlim(0, 2 * fp)
    axes[1].set_ylim(-0.2, 0.1)
    axes[1].set_title("passband ripple (dB)")
    axes[2].plot(f, 20 * np.log10(H + 1e-300))
    axes[2].set_xlim(0, min(20 * fs, 1.0))
    axes[2].set_ylim(-160, 3)
    axes[2].set_title("stopband (dB)")
    axes[0].legend()
    fig.tight_layout()
    fig.savefig(output_path)
    return fig


def critical_points(h: np.ndarray, n_chan: int,
                    output_path: str = "critical_points.png"):
    """Tap-boundary plot (critical_points.m): impulse response with channel
    (tap-phase) boundary markers."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(h)
    for k in range(0, h.size, n_chan):
        ax.axvline(k, color="k", alpha=0.15)
    ax.set_title(f"{h.size} taps, {h.size / n_chan:.1f} per channel")
    fig.savefig(output_path)
    return fig


def fft_impulse_response(fft_length: int = 1024, overlap: int = 128,
                         output_path: str = "fft_impulse_response.png"):
    """Aliasing visualization of blockwise FFT processing
    (fft_impulse_response.py): response of one overlap-save block to
    impulses swept across it."""
    plt = _pyplot()
    win = np.zeros(fft_length)
    win[overlap: fft_length - overlap] = 1.0
    fig, ax = plt.subplots(figsize=(10, 5))
    for pos in np.linspace(0, fft_length - 1, 8).astype(int):
        x = np.zeros(fft_length, dtype=np.complex128)
        x[pos] = 1.0
        y = np.fft.ifft(np.fft.fft(x * win))
        ax.plot(20 * np.log10(np.abs(y) + 1e-300), alpha=0.6, label=f"pos {pos}")
    ax.set_ylim(-120, 5)
    ax.legend(fontsize=7)
    ax.set_title("blockwise FFT impulse response (windowed overlap-save)")
    fig.savefig(output_path)
    return fig


def single_double_fft(n: int = 2**20, seed: int = 0,
                      output_path: str = "single_double_fft.png"):
    """fp32 vs fp64 FFT error floor characterization
    (single_double_fft.py / matlab twin): returns (mean, max) relative error
    and saves the error spectrum."""
    plt = _pyplot()
    rng = np.random.default_rng(seed)
    x64 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x32 = x64.astype(np.complex64)
    f64 = np.fft.fft(x64)
    f32 = np.fft.fft(x32).astype(np.complex128)
    rel = np.abs(f32 - f64) / np.abs(f64).max()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.semilogy(rel[:: max(1, n // 4096)])
    ax.set_title(f"fp32 vs fp64 FFT, n={n}: mean rel {rel.mean():.2e}, "
                 f"max {rel.max():.2e}")
    fig.savefig(output_path)
    return float(rel.mean()), float(rel.max())


def bit_histogram(dada_path: str, output_path: Optional[str] = None):
    """Histogram of sample values (bit_histogram.m) — sanity check of
    quantized products."""
    plt = _pyplot()
    data, header = dada.load(dada_path)
    vals = np.concatenate([data.real.ravel(), data.imag.ravel()])
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.hist(vals, bins=min(256, max(16, int(vals.max() - vals.min() + 1))))
    ax.set_title(f"NBIT={header.get('NBIT')} value histogram")
    fig.savefig(output_path or dada_path + ".hist.png")
    return fig
