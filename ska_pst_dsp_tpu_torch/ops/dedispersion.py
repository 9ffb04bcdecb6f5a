"""Coherent dedispersion.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.dedispersion`. The interstellar
medium delays frequency f by t(f) = k_DM * DM * (f^-2 - f_ref^-2),
k_DM = 4.149377593e3 s MHz^2 pc^-1 cm^3; the frequency-domain chirp

    H(f0 + df) = exp(+2j*pi * k_DM * DM * df^2 / (f0^2 * (f0 + df)))

(the dspsr/PSRCHIVE convention) removes it exactly. :func:`dedisperse`
applies it to a whole block (FFT, chirp, IFFT on ``torch.fft``; the JAX
package has no kernel for it either). Inside the Golden inversion the chirp
rides the ``spectral_filter`` slot: it becomes the epilogue's ``elem``
factor, on the cluster epilogue or the out-of-core pair
(:func:`.kernels.synthesis_fused.polyphase_synthesis_fused`).

A node that inverts many coarse channels at once dedisperses each at its
own centre frequency: :func:`chirp_table` is one chirp a coarse channel,
the inversion's ``elem`` as a ``(rows, N)`` table whose row ``p % rows``
stream p reads (:class:`Dedispersion` describes the band,
``models.two_stage.TwoStageInverseFilterBank`` builds and checks it). Each
chirp refers its channel to its own centre: the delay between channels is
left to the folding, as dspsr leaves it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from . import cfft

#: dispersion constant, s MHz^2 / (pc cm^-3) (Manchester & Taylor)
KDM = 4.149377593e3


def dispersion_delay(dm: float, freq_mhz: float, ref_freq_mhz: float) -> float:
    """Time delay (seconds) of freq relative to ref."""
    return KDM * dm * (freq_mhz**-2 - ref_freq_mhz**-2)


def chirp_phase(n: int, dm: float, center_freq_mhz: float, bw_mhz: float) -> np.ndarray:
    """Phase (radians, fp64) of the coherent-dedispersion chirp at the n FFT
    bin frequencies of a complex baseband channel centered at
    ``center_freq_mhz`` spanning ``bw_mhz``."""
    # FFT bin -> baseband offset in [-bw/2, bw/2)
    k = np.arange(n)
    df = (np.where(k < n - n // 2, k, k - n) / n) * bw_mhz
    f0 = center_freq_mhz
    return (
        2.0 * np.pi * KDM * 1e6 * dm * df**2 / (f0**2 * (f0 + df))
    )  # 1e6: k_DM in s -> phase at MHz frequencies


def chirp_table(n: int, dm: float, centres_mhz, bw_mhz: float) -> np.ndarray:
    """(len(centres_mhz), n) complex64: row r :func:`chirp_filter` at
    ``centres_mhz[r]``, its phases taken in float64 (they reach ~3e3 rad
    at 150 MHz, where float32 would be off by ~2e-4 rad)."""
    centres = np.asarray(centres_mhz, dtype=np.float64).reshape(-1)
    return np.stack([chirp_filter(n, dm, f0, bw_mhz) for f0 in centres])


def reach_samples(dm: float, centre_mhz: float, bw_mhz: float) -> float:
    """The larger one-sided extent of the chirp's response, in samples at
    ``bw_mhz`` complex sampling: the delay of the channel's lower edge
    behind its centre (a little over half the smear across the channel).
    The inversion's output discard on each side has to hold it beside the
    temporal taper."""
    return dispersion_delay(dm, centre_mhz - bw_mhz / 2, centre_mhz) * bw_mhz * 1e6


@dataclasses.dataclass(frozen=True)
class Dedispersion:
    """Coherent dedispersion at ``dm`` of a band of coarse channels, in
    their output order: the first centred at ``first_centre_mhz``, each
    next ``coarse_bw_mhz`` higher, each ``coarse_bw_mhz`` wide (the
    inversion's output rate)."""

    dm: float
    first_centre_mhz: float
    coarse_bw_mhz: float

    def __post_init__(self):
        if self.coarse_bw_mhz <= 0 or self.first_centre_mhz <= self.coarse_bw_mhz / 2:
            raise ValueError(f"a band needs coarse_bw_mhz > 0 and every channel above 0 MHz: "
                             f"{self}")

    def centres(self, channels: int) -> np.ndarray:
        """The centres of the first ``channels`` coarse channels, MHz."""
        return self.first_centre_mhz + self.coarse_bw_mhz * np.arange(channels)

    def reach(self) -> float:
        """:func:`reach_samples` of the lowest channel, the first: the
        largest of the band's (its size, for a dispersing, negative DM
        too)."""
        return abs(reach_samples(self.dm, self.first_centre_mhz, self.coarse_bw_mhz))

    def table(self, n: int, channels: int, centred: bool = False) -> np.ndarray:
        """:func:`chirp_table` of the first ``channels`` coarse channels at
        n points; ``centred``: each row fftshifted, bin k at offset
        (k - n/2)/n * bw, for a spectrum that holds the channel's centre at
        bin n/2 (the inversion of monotonic fine channels)."""
        table = chirp_table(n, self.dm, self.centres(channels), self.coarse_bw_mhz)
        return np.fft.fftshift(table, axes=-1) if centred else table


def chirp_filter(n: int, dm: float, center_freq_mhz: float, bw_mhz: float,
                 inverse: bool = False, *, pair: bool = False
                 ) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """The chirp as complex64, or as the JAX package's (re, im) float32
    pair with ``pair=True``; ``inverse=True`` disperses instead of
    dedispersing."""
    phase = chirp_phase(n, dm, center_freq_mhz, bw_mhz)
    if inverse:
        phase = -phase
    re, im = np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)
    return (re, im) if pair else (re + 1j * im).astype(np.complex64)


def dedisperse(x, dm: float, center_freq_mhz: float, bw_mhz: float, *,
               inverse: bool = False):
    """Coherently (de)disperse a complex baseband stream.

    x: (..., n) complex tensor/array or (re, im) pair; the transform runs
    over the last axis as one whole-block convolution, on x's device.
    Returns the same kind."""
    z, pair = cfft.as_complex(x)
    h = torch.as_tensor(chirp_filter(z.shape[-1], dm, center_freq_mhz, bw_mhz,
                                     inverse=inverse), device=z.device)
    return cfft.same_kind(torch.fft.ifft(torch.fft.fft(z, dim=-1) * h, dim=-1), pair)
