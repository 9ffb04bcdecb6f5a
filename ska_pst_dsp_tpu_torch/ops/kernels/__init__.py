"""Hand-written CUDA kernels of the fused SKA-Low and SKA-Mid round trips.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas`. Each kernel module holds a
wrapper that launches its kernel for a CUDA tensor and runs the plain
PyTorch version beside it for a CPU tensor (the only reason it ever takes
the plain path), plus an integer ``launches`` counter on the wrapper that
goes up by one each time the kernel is launched:

* :mod:`.analysis_fused`  — fold + DFT + derotation ramp;
* :mod:`.synthesis_fused` — inversion frontend, and the epilogue dispatch;
* :mod:`.ifft_fused`      — the inversion's backward-FFT epilogue;
* :mod:`.analysis_padded_fused` — the zero-padded (SKA-Mid) analysis fold;
* :mod:`.chan_dft_fused`  — mid's channel DFT + derotation constant;
* :mod:`.ifft_big`        — mid's out-of-core epilogue (two launches).

The sources live in ``ska_pst_dsp_tpu_torch/csrc/``; :mod:`._build` compiles
them on first use. This module holds the host-side helpers the wrappers
share.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

#: shared memory one thread block may use on the H100 (bytes)
SMEM_LIMIT = 232_448

#: odd factors the kernels are instantiated for (n = r * 2^k): the low
#: path's DFT lengths are 256, 128 and 384 = 3 * 128; mid's are 4096, 512
#: and 3584 = 7 * 512 (its 1,835,008-point IFFT is 7 * 2^18)
RADICES = (1, 3, 7)


def radix(n: int) -> Tuple[int, int, int]:
    """(r, q, log2 q) with n = r * q, q = 2^log2q and r odd — the split of
    the shared-memory DFT (csrc/dft_smem.cuh)."""
    if n <= 0:
        raise ValueError(f"DFT length must be positive, got {n}")
    logq = (n & -n).bit_length() - 1
    r = n >> logq
    if r not in RADICES:
        raise ValueError(
            f"DFT length {n} = {r} * 2^{logq}: the kernels take odd factors "
            f"{RADICES} only"
        )
    return r, 1 << logq, logq


def twiddle_table(n: int, sign: int) -> np.ndarray:
    """(n,) complex64 table exp(sign * 2*pi*i*m/n), m = 0..n-1, computed in
    float64 from the exact integer m."""
    m = np.arange(n, dtype=np.float64)
    return np.exp(sign * 2j * np.pi * m / n).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def twiddles(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """:func:`twiddle_table` on ``device``, built once per (n, sign, device)."""
    return torch.as_tensor(twiddle_table(n, sign), device=device)


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Check a kernel operand's dtype and device; return it contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    return t.contiguous()


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream of t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
