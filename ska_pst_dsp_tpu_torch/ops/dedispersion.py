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
"""

from __future__ import annotations

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
