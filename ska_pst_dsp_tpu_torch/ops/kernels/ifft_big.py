"""Out-of-core backward-FFT epilogue for SKA-Mid-class block lengths.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas.ifft_big`:

    IFFT(roll(X * elem, -roll))[lo:N-lo] * gain

per assembled block, for N too large for one thread block (mid:
N = 1,835,008). The CUDA source (``csrc/ifft_big.cu``) runs the four-step
split N = n2 * n1 as two kernels, each with its own ``launches`` counter:

* :func:`ifft_big_inner` — the n2-point DFT of each column i1, times
  ``elem`` on the way in (plain version
  :func:`ska_pst_dsp_tpu_torch.ops.synthesis.big_ifft_inner`);
* :func:`ifft_big_outer` — the N-level twiddle, the n1-point DFT over the
  kept outputs only, the roll phase and gain (plain version
  :func:`ska_pst_dsp_tpu_torch.ops.synthesis.big_ifft_outer`).

:func:`fused_big_ifft_oc` runs the pair, one inner and one outer launch over
the whole batch through a scratch A of the batch's size; its plain version
is :func:`ska_pst_dsp_tpu_torch.ops.synthesis.epilogue`. The host tables of
the kernels come from :func:`big_ifft_tables`.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import cfft
from ..synthesis import big_ifft_inner, big_ifft_outer, epilogue
from . import kernel, launch, on_card, phase_table, require, twiddle_table

#: largest outer transform of the split (the JAX package's cfft.BASE)
_BASE = 512
#: the JAX plan's delta-axis chunk (q must be a multiple of it)
_CHUNK = 128
#: the N-level twiddle w_N^(i1*k2) = row_hi[k2, i1 // LANES] * row_lo[k2, i1 % LANES]
LANES = 32
#: (r, log2 q) splits n = r * 2^logq the kernels are instantiated for
INNER_SPLITS = {(r, 9) for r in (1, 2, 3, 4, 6, 7, 8)} | {(r, lq) for r in (1, 3, 7)
                                                        for lq in (7, 8)}
OUTER_SPLITS = {(1, 7), (1, 8), (1, 9), (3, 7)}


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


def _split(n: int) -> Tuple[int, int]:
    logq = min((n & -n).bit_length() - 1, 9)
    return n >> logq, logq


def takes(n2: int, n1: int) -> bool:
    """Whether the card has the pair of kernels for the split n = n2 * n1:
    an inner kernel for n2 and an outer one for n1."""
    return (n2 > 0 and n1 > 0 and _split(n2) in INNER_SPLITS
            and _split(n1) in OUTER_SPLITS)


def kernel_split(n: int, splits=INNER_SPLITS) -> Tuple[int, int]:
    """(r, log2 q) with n = r * 2^logq and 2^logq = min(512, the power of
    two in n): the radix-r step and the register-pass transform of the
    kernels. Raises for a split they are not instantiated for."""
    r, logq = _split(n)
    if (r, logq) not in splits:
        raise ValueError(f"DFT length {n} = {r} * 2^{logq}: the out-of-core kernels "
                         f"take {sorted(splits)}")
    return r, logq


def big_ifft_tables(n: int, n2: int, n1: int, roll: int) -> Dict[str, np.ndarray]:
    """The kernels' host tables, complex64, each built in float64 from exact
    integers: ``tw_n2``, ``tw_n1`` (w_n2^m, w_n1^m); ``row_hi``, ``row_lo``
    ((n2, n1/32) w_N^(32*s*k2) and (n2, 32) w_N^(l*k2): the N-level twiddle
    w_N^(i1*k2) is row_hi[k2, i1 // 32] * row_lo[k2, i1 % 32]); ``roll_row``,
    ``roll_col`` (w_N^(-roll*k2), w_N^(-roll*n2*k1): the roll phase
    w_N^(-roll*t) of t = k2 + n2*k1 is their product)."""
    k2 = np.arange(n2, dtype=np.int64)[:, None]
    return {
        "tw_n2": twiddle_table(n2, 1),
        "tw_n1": twiddle_table(n1, 1),
        "row_hi": phase_table(k2 * (LANES * np.arange(n1 // LANES)), n, 1),
        "row_lo": phase_table(k2 * np.arange(LANES), n, 1),
        "roll_row": phase_table(roll * np.arange(n2), n, -1),
        "roll_col": phase_table(roll * n2 * np.arange(n1), n, -1),
    }


@functools.lru_cache(maxsize=None)
def _device_tables(n: int, n2: int, n1: int, roll: int,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device)
            for k, v in big_ifft_tables(n, n2, n1, roll).items()}


def _check_x(x: torch.Tensor, elem: Optional[torch.Tensor], n: int):
    if x.dtype != torch.complex64 or x.ndim != 3 or x.shape[2] != n:
        raise ValueError(f"x must be (n_pol, B, {n}) complex64, got {tuple(x.shape)}")
    if x.stride(2) != 1:
        x = x.contiguous()
    if elem is not None:
        elem = require(elem, "elem", torch.complex64, x.device)
        if elem.shape != (n,):
            raise ValueError(f"elem must be ({n},), got {tuple(elem.shape)}")
    return x, elem


def _keep_rows(n: int, n2: int, lo: int) -> Tuple[int, int]:
    if lo % n2 or (n - 2 * lo) <= 0 or (n - 2 * lo) % n2:
        raise ValueError(f"keep region [{lo}, {n - lo}) is not whole n2={n2} rows")
    return lo // n2, (n - 2 * lo) // n2


@kernel("ifft_big_inner", plain=big_ifft_inner)
def ifft_big_inner(x: torch.Tensor, elem: Optional[torch.Tensor], n2: int,
                   n1: int) -> torch.Tensor:
    """(n_pol, B, n2*n1) complex64, bins contiguous -> A (n_pol, B, n2, n1):
    the n2-point backward DFT of each column i1 of X*elem. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel once over the
    batch."""
    n = n2 * n1
    x, elem = _check_x(x, elem, n)
    r2, logq2 = kernel_split(n2)
    n_pol, n_b, _ = x.shape
    a = torch.empty((n_pol, n_b, n2, n1), dtype=torch.complex64, device=x.device)
    tab = _device_tables(n, n2, n1, 0, x.device)
    launch(ifft_big_inner, "ifft_big_inner_launch", x,
           x.data_ptr(), None if elem is None else elem.data_ptr(), a.data_ptr(),
           tab["tw_n2"].data_ptr(), x.stride(0), x.stride(1), n_pol, n_b, n2, r2,
           logq2, n1)
    return a


@kernel("ifft_big_outer", plain=big_ifft_outer)
def ifft_big_outer(a: torch.Tensor, lo: int, roll: int, gain: float) -> torch.Tensor:
    """A (n_pol, B, n2, n1) -> (n_pol, B, N - 2*lo): N-level twiddle, the
    n1-point backward DFT over the kept outputs t = k2 + n2*k1 in
    [lo, N - lo), the roll phase and gain/N. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel once over the batch."""
    a = require(a, "a", torch.complex64, a.device)
    if a.ndim != 4:
        raise ValueError(f"a must be (n_pol, B, n2, n1), got {tuple(a.shape)}")
    n_pol, n_b, n2, n1 = a.shape
    n = n2 * n1
    k1_lo, n1_keep = _keep_rows(n, n2, lo)
    r1, logq1 = kernel_split(n1, OUTER_SPLITS)
    out = torch.empty((n_pol, n_b, n - 2 * lo), dtype=torch.complex64, device=a.device)
    tab = _device_tables(n, n2, n1, roll % n, a.device)
    launch(ifft_big_outer, "ifft_big_outer_launch", a,
           a.data_ptr(), out.data_ptr(), *(tab[k].data_ptr() for k in (
               "tw_n1", "row_hi", "row_lo", "roll_row", "roll_col")),
           n_pol * n_b, n2, n1, r1, logq1, k1_lo, n1_keep, gain / n)
    return out


def fused_big_ifft_oc(flat, elem=None, *, shape_key):
    """Out-of-core IFFT(roll(X * elem, -roll)) * gain, keeping [lo, N-lo).

    flat: (n_pol, B, N) assembled spectra, complex or an (re, im) pair
    (same kind out); elem: optional (N,) factor, pre-rolled by +roll
    (ValueError for a (rows, N) table: no row of it is applied to every stream);
    shape_key: (n, p, q, n1, lo, roll, gain), the JAX package's key with
    :func:`plan_big_ifft`'s split, n = p*q*n1 (the inversion passes p = 1,
    q = n2 of :func:`.synthesis_fused.epilogue_plan`'s split). Returns
    (n_pol, B, N - 2*lo). A CPU tensor runs the plain epilogue; a CUDA
    tensor launches :func:`ifft_big_inner` then :func:`ifft_big_outer` once
    each over the batch."""
    n, p, q, n1, lo, roll, gain = shape_key
    x, pair = cfft.as_complex(flat)
    e = None if elem is None else cfft.as_complex(elem)[0]
    if e is not None and e.ndim != 1:
        raise ValueError(f"fused_big_ifft_oc applies one (N,) elem to every stream, got "
                         f"{tuple(e.shape)}: a (rows, N) table runs on inversion_fused or "
                         f"the composed epilogue")
    if n != p * q * n1 or x.shape[-1] != n:
        raise ValueError(f"flat must be (n_pol, B, {n}) with n = p*q*n1")
    if x.device.type == "cpu":
        return cfft.same_kind(epilogue(x, e, lo, roll, gain, x.shape[1]), pair)
    on_card("fused_big_ifft_oc", x.device)
    kernel_split(n1, OUTER_SPLITS)  # raise before the first launch
    _keep_rows(n, p * q, lo)
    a = ifft_big_inner(x, e, p * q, n1)
    return cfft.same_kind(ifft_big_outer(a, lo, roll, gain), pair)
