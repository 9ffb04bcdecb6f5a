"""Out-of-core backward-FFT epilogue for SKA-Mid-class block lengths.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas.ifft_big`:

    IFFT(roll(X * elem, -roll))[lo:N-lo] * gain

per assembled block, for N too large for one thread block (mid:
N = 1,835,008). The CUDA source (``csrc/ifft_big.cu``) runs the four-step
split N = n2 * n1 as two kernels that meet in device memory, each with its
own wrapper and ``launches`` counter:

* :func:`ifft_big_inner` — the n2-point DFT of each column i1, times
  ``elem`` on the way in (plain version
  :func:`ska_pst_dsp_tpu_torch.ops.synthesis.big_ifft_inner`);
* :func:`ifft_big_outer` — the N-level twiddle, the n1-point DFT over the
  kept outputs only, the roll phase and gain (plain version
  :func:`ska_pst_dsp_tpu_torch.ops.synthesis.big_ifft_outer`).

:func:`fused_big_ifft_oc` chains them; its plain version is
:func:`ska_pst_dsp_tpu_torch.ops.synthesis.epilogue`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import cfft
from ..synthesis import big_ifft_inner, big_ifft_outer, epilogue
from . import SMEM_LIMIT, _build, radix, require, stream_of, twiddles

#: largest outer transform of the split (the JAX package's cfft.BASE)
_BASE = 512
#: the JAX plan's delta-axis chunk (q must be a multiple of it)
_CHUNK = 128
#: i1 columns per inner thread block (csrc/ifft_big.cu kColTile)
COL_TILE = 4


def _split_factor(n: int) -> int:
    """Largest divisor of n that is <= 512 (JAX ops/cfft.py _split_factor)."""
    divisors = (d for i in range(1, math.isqrt(n) + 1) if n % i == 0
                for d in (i, n // i))
    return max(d for d in divisors if d <= _BASE)


def plan_big_ifft(n: int, lo: int) -> Optional[Tuple[int, int, int]]:
    """(p, q, n1) three-factor split of the out-of-core epilogue, or None —
    the JAX package's rule (ops/pallas/ifft_big.py plan_big_ifft): n1 the
    largest divisor <= 512 and a multiple of 128, n2 = n/n1 = p*q with q
    the largest multiple of 128 <= 512 and p <= 8, lo and the keep region
    whole n2 rows, and n1*n2 phases exact in fp32."""
    n1 = _split_factor(n)
    if n1 == 1:
        return None
    n2 = n // n1
    if n1 % 128 or n1 > 512 or (n - 2 * lo) <= 0 or lo % n2:
        return None
    if (n1 - 1) * (n2 - 1) >= 2 ** 24:
        return None
    q = next((c for c in range(min(512, n2), 0, -1)
              if n2 % c == 0 and n2 // c <= 8 and c % _CHUNK == 0), 0)
    if not q or (n - 2 * lo) % n2:
        return None
    return n2 // q, q, n1


def ifft_big_inner(x: torch.Tensor, elem: Optional[torch.Tensor], n2: int,
                   n1: int) -> torch.Tensor:
    """(n_pol, B, n2*n1) complex64, bins contiguous -> A (n_pol, B, n2, n1):
    the n2-point backward DFT of each column i1 of X*elem. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return big_ifft_inner(x, elem, n2, n1)
    if x.device.type != "cuda":
        raise ValueError(f"ifft_big_inner runs on cuda or cpu, not {x.device}")
    dev = x.device
    n = n2 * n1
    if x.dtype != torch.complex64 or x.ndim != 3 or x.shape[2] != n:
        raise ValueError(f"x must be (n_pol, B, {n}) complex64, got {tuple(x.shape)}")
    if x.stride(2) != 1:
        x = x.contiguous()
    if elem is not None:
        elem = require(elem, "elem", torch.complex64, dev)
        if elem.shape != (n,):
            raise ValueError(f"elem must be ({n},), got {tuple(elem.shape)}")
    if COL_TILE * (n2 + 1) * 8 > SMEM_LIMIT:
        raise ValueError(f"{COL_TILE} columns of {n2} do not fit in shared memory")
    r2, q2, logq2 = radix(n2)
    n_pol, n_b, _ = x.shape
    a = torch.empty((n_pol, n_b, n2, n1), dtype=torch.complex64, device=dev)
    tab = twiddles(n, 1, dev)
    with torch.cuda.device(dev):
        status = _build.library().ifft_big_inner_launch(
            x.data_ptr(), None if elem is None else elem.data_ptr(), a.data_ptr(),
            tab.data_ptr(), x.stride(0), x.stride(1), n_pol, n_b, n, n2, r2, q2,
            logq2, n1, stream_of(x),
        )
    _build.check(status, "ifft_big_inner")
    ifft_big_inner.launches += 1
    return a


ifft_big_inner.launches = 0


def ifft_big_outer(a: torch.Tensor, lo: int, roll: int, gain: float) -> torch.Tensor:
    """A (n_pol, B, n2, n1) -> (n_pol, B, N - 2*lo): N-level twiddle, the
    n1-point backward DFT over the kept outputs t = k2 + n2*k1 in
    [lo, N - lo), the roll phase and gain/N. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel."""
    if a.device.type == "cpu":
        return big_ifft_outer(a, lo, roll, gain)
    if a.device.type != "cuda":
        raise ValueError(f"ifft_big_outer runs on cuda or cpu, not {a.device}")
    dev = a.device
    a = require(a, "a", torch.complex64, dev)
    if a.ndim != 4:
        raise ValueError(f"a must be (n_pol, B, n2, n1), got {tuple(a.shape)}")
    n_pol, n_b, n2, n1 = a.shape
    n = n2 * n1
    if lo % n2 or (n - 2 * lo) <= 0 or (n - 2 * lo) % n2:
        raise ValueError(f"keep region [{lo}, {n - lo}) is not whole n2={n2} rows")
    r1, q1, logq1 = radix(n1)
    out = torch.empty((n_pol, n_b, n - 2 * lo), dtype=torch.complex64, device=dev)
    tab = twiddles(n, 1, dev)
    with torch.cuda.device(dev):
        status = _build.library().ifft_big_outer_launch(
            a.data_ptr(), out.data_ptr(), tab.data_ptr(), n_pol, n_b, n, n2, n1, r1,
            q1, logq1, lo // n2, (n - 2 * lo) // n2, lo, roll % n, gain / n,
            stream_of(a),
        )
    _build.check(status, "ifft_big_outer")
    ifft_big_outer.launches += 1
    return out


ifft_big_outer.launches = 0


def fused_big_ifft_oc(flat, elem=None, *, shape_key):
    """Out-of-core IFFT(roll(X * elem, -roll)) * gain, keeping [lo, N-lo).

    flat: (n_pol, B, N) assembled spectra, complex or an (re, im) pair
    (same kind out); elem: optional (N,) factor, pre-rolled by +roll;
    shape_key: (n, p, q, n1, lo, roll, gain) from :func:`plan_big_ifft`.
    Returns (n_pol, B, N - 2*lo). A CPU tensor runs the plain epilogue; a
    CUDA tensor launches the two kernels."""
    n, p, q, n1, lo, roll, gain = shape_key
    x, pair = cfft.as_complex(flat)
    e = None if elem is None else cfft.as_complex(elem)[0]
    if n != p * q * n1 or x.shape[-1] != n:
        raise ValueError(f"flat must be (n_pol, B, {n}) with n = p*q*n1")
    if x.device.type == "cpu":
        return cfft.same_kind(epilogue(x, e, lo, roll, gain, x.shape[1]), pair)
    a = ifft_big_inner(x, e, p * q, n1)
    return cfft.same_kind(ifft_big_outer(a, lo, roll, gain), pair)
