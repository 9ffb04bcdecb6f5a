"""Hand-written CUDA kernels of the fused SKA-Low and SKA-Mid round trips.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas`. Each kernel module holds a
wrapper that launches its kernel for a CUDA tensor and runs the plain
PyTorch version beside it for a CPU tensor (the only reason it ever takes
the plain path), an integer ``launches`` counter on the wrapper that goes
up by one each time the kernel is launched, and a pure predicate ``takes``
that says which geometries the card has an instantiated kernel for. On a
CUDA tensor the wrapper raises ValueError from that predicate, and so do the
public drop-in functions (``polyphase_*_fused``, ``fused_inversion``) built
on it: nothing on the card gives way to the plain version:

* :mod:`.analysis_fused`  — fold + DFT + derotation ramp;
* :mod:`.synthesis_fused` — inversion frontend, and the epilogue dispatch;
* :mod:`.ifft_fused`      — the inversion's backward-FFT epilogue, one
  thread-block cluster per transform;
* :mod:`.analysis_padded_fused` — the zero-padded (SKA-Mid) analysis fold,
  one persistent launch on asynchronous bulk copies;
* :mod:`.chan_dft_fused`  — mid's channel DFT + derotation constant;
* :mod:`.ifft_big`        — mid's out-of-core epilogue (two launches);
* :mod:`.dada_unpack`     — the DADA ingest engine's unpacks (file words
  to complex64 planes, TFP and LowCBF) and pack (the write side), which
  replace the JAX package's host C++ engine, not a Pallas kernel;
* :mod:`.inversion_fused` — the SKA-Low inversion's frontend and cluster
  epilogue in one kernel, the assembled spectra kept in the cluster's
  shared memory (fuses two Pallas kernels' ports; replaces neither alone).

The sources live in ``ska_pst_dsp_tpu_torch/csrc/``; :mod:`._build` compiles
them on first use. This module holds the host-side helpers the wrappers
share: the odd-factor split of a transform length, exact phase tables, and
the plan and twiddle tables of the register passes (``csrc/fft_reg.cuh``)
that every kernel with a DFT runs on.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

#: shared memory one thread block may use on the H100 (bytes)
SMEM_LIMIT = 232_448

#: odd factors of a transform length n = r * 2^k the port splits off:
#: csrc/ifft_big.cu's radix-r step takes all three, analysis_fused's and
#: chan_dft_fused's are instantiated for r in {1, 3}
RADICES = (1, 3, 7)


def wrappers() -> Dict[str, Callable]:
    """The eleven kernels' wrappers, every one with its ``launches``
    counter: the seven by the name of the Pallas kernel each replaces, then
    the ingest engine's three, then the fused SKA-Low inversion."""
    from .analysis_fused import analysis_fused
    from .analysis_padded_fused import padded_fold_fused
    from .chan_dft_fused import chan_dft_ramp
    from .dada_unpack import dada_pack, dada_unpack, lowcbf_unpack
    from .ifft_big import ifft_big_inner, ifft_big_outer
    from .ifft_fused import fused_big_ifft
    from .inversion_fused import inversion_fused
    from .synthesis_fused import synthesis_fused

    return {"analysis_fused": analysis_fused, "synthesis_fused": synthesis_fused,
            "ifft_fused": fused_big_ifft, "analysis_padded_fused": padded_fold_fused,
            "chan_dft_fused": chan_dft_ramp, "ifft_big_inner": ifft_big_inner,
            "ifft_big_outer": ifft_big_outer, "dada_unpack": dada_unpack,
            "lowcbf_unpack": lowcbf_unpack, "dada_pack": dada_pack,
            "inversion_fused": inversion_fused}


def radix(n: int) -> Tuple[int, int, int]:
    """(r, q, log2 q) with n = r * q, q = 2^log2q and r odd: the radix-r
    step and the power-of-two transform of a kernel's DFT."""
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


def phase_table(idx, n: int, sign: int) -> np.ndarray:
    """exp(sign * 2*pi*i*idx/n) as complex64 for integer ``idx`` of any
    shape, the angle taken in float64 from the exact integer idx mod n."""
    return np.exp(sign * 2j * np.pi * (np.asarray(idx, np.int64) % n) / n).astype(np.complex64)


def reg_plan(q: int) -> Tuple[int, int]:
    """(passes, last radix) of a q-point transform on csrc/fft_reg.cuh's
    register passes (FftRegPlan): ceil(log2(q) / 3) passes, all of radix 8
    but the last, of radix 2, 4 or 8. q = 2^k, 128 <= q <= 4096."""
    logq = q.bit_length() - 1
    if q != 1 << logq or not 7 <= logq <= 12:
        raise ValueError(f"register-pass transforms take 2^7..2^12 points, got {q}")
    passes = -(-logq // 3)
    return passes, q >> (3 * (passes - 1))


def pass_twiddles(q: int, sign: int) -> np.ndarray:
    """The per-pass twiddle table of a q-point transform of sign ``sign`` on
    the register passes (csrc/fft_reg.cuh fft_reg_pass_tw): for each radix-8
    pass s but the last, of span h = q / 8^(s+1), 7 rows d = 1..7 of h
    entries exp(sign * 2*pi*i*j*d/(8h)), j < h. complex64, each angle taken
    in float64 from the exact integer j*d; q - (last radix) entries."""
    passes, last = reg_plan(q)
    parts = []
    for s in range(passes - 1):
        h = q >> (3 * (s + 1))
        jd = np.arange(1, 8)[:, None] * np.arange(h)[None, :]
        parts.append(np.exp(sign * 2j * np.pi * jd / (8 * h)).ravel())
    out = np.concatenate(parts).astype(np.complex64)
    assert out.size == q - last
    return out


@functools.lru_cache(maxsize=None)
def device_pass_twiddles(q: int, sign: int, device: torch.device) -> torch.Tensor:
    """:func:`pass_twiddles` on ``device``, built once per (q, sign, device)."""
    return torch.as_tensor(pass_twiddles(q, sign), device=device)


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


#: the current stream's raw handle by device index, without building a
#: torch.cuda.Stream (a few microseconds a call); None where torch lacks it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream of t's device."""
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream
