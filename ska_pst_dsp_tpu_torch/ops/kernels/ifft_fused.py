"""Fused backward-FFT epilogue of the Golden inversion.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas.ifft_fused`:

    IFFT(roll(X * elem, -roll))[lo:N-lo] * gain

per assembled block, with ``elem`` (spectral taper x filter) pre-rolled by
+roll. The CUDA kernel (``csrc/ifft_fused.cu``) runs the four-step split
N = n2 * n1 as two launches through device memory (a 49152-point block
does not fit in one thread block's shared memory) and computes only the
kept output rows. Its plain version is
:func:`ska_pst_dsp_tpu_torch.ops.synthesis.epilogue`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import cfft
from ..synthesis import epilogue
from . import _build, radix, require, stream_of, twiddles


def plan_ifft(n: int, lo: int) -> Optional[Tuple[int, int]]:
    """(n2, n1) factorization of the fused epilogue, or None — the same
    rule as the JAX package's plan (the smallest n2 that is a multiple of
    128 with n1 <= 512, n1 % 8 == 0 and the keep region a whole number of
    n2 rows, a multiple of 8 of them), so both packages send the same
    geometries through their fused epilogue."""
    if (n - 2 * lo) <= 0:
        return None
    for n2 in range(128, 513, 128):
        if n % n2:
            continue
        n1 = n // n2
        if n1 > 512 or n1 % 8:
            continue
        if lo % n2 or (n - 2 * lo) % n2:
            continue
        if ((n - 2 * lo) // n2) % 8:
            continue
        return n2, n1
    return None


def fused_big_ifft(flat, elem=None, *, shape_key, n_valid: Optional[int] = None):
    """Fused IFFT(roll(X * elem, -roll)) * gain, keeping [lo, N-lo).

    flat: (n_pol, B, N) assembled spectra, complex or an (re, im) pair
    (same kind out); elem: optional (N,) factor, pre-rolled by +roll;
    shape_key: (n, n2, n1, lo, roll, gain) with n == n2 * n1. Returns
    (n_pol, n_valid, N - 2*lo); blocks past ``n_valid`` (default all) are
    never computed. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel."""
    n, n2, n1, lo, roll, gain = shape_key
    x, pair = cfft.as_complex(flat)
    e = None if elem is None else cfft.as_complex(elem)[0]
    if n_valid is None:
        n_valid = x.shape[1]
    if x.device.type == "cpu":
        return cfft.same_kind(epilogue(x, e, lo, roll, gain, n_valid), pair)
    if x.device.type != "cuda":
        raise ValueError(f"fused_big_ifft runs on cuda or cpu, not {x.device}")
    dev = x.device
    if x.dtype != torch.complex64:
        raise TypeError(f"flat must be complex64, got {x.dtype}")
    if x.ndim != 3 or x.shape[2] != n or n != n2 * n1:
        raise ValueError(f"flat must be (n_pol, B, {n}) with n = n2*n1")
    if not 0 < n_valid <= x.shape[1]:
        raise ValueError(f"n_valid={n_valid} outside [1, {x.shape[1]}]")
    if lo % n2 or (n - 2 * lo) <= 0 or (n - 2 * lo) % n2:
        raise ValueError(f"keep region [{lo}, {n - lo}) is not whole n2={n2} rows")
    if x.stride(2) != 1:
        x = x.contiguous()
    if e is not None:
        e = require(e, "elem", torch.complex64, dev)
        if e.shape != (n,):
            raise ValueError(f"elem must be ({n},), got {tuple(e.shape)}")
    r2, q2, logq2 = radix(n2)
    r1, q1, logq1 = radix(n1)
    n_pol = x.shape[0]
    scratch = torch.empty((n_pol, n_valid, n), dtype=torch.complex64, device=dev)
    out = torch.empty((n_pol, n_valid, n - 2 * lo), dtype=torch.complex64, device=dev)
    tab = twiddles(n, 1, dev)
    with torch.cuda.device(dev):
        status = _build.library().ifft_fused_launch(
            x.data_ptr(), None if e is None else e.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), tab.data_ptr(),
            x.stride(0), x.stride(1), n_pol, n_valid, n, n2, r2, q2, logq2,
            n1, r1, q1, logq1, lo // n2, (n - 2 * lo) // n2, roll % n,
            gain / n, stream_of(x),
        )
    _build.check(status, "fused_big_ifft")
    fused_big_ifft.launches += 1
    return cfft.same_kind(out, pair)


fused_big_ifft.launches = 0
