"""Fused backward-FFT epilogue of the Golden inversion.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas.ifft_fused`:

    IFFT(roll(X * elem, -roll))[lo:N-lo] * gain

per assembled block, with ``elem`` (spectral taper x filter) pre-rolled by
+roll. The CUDA kernel (``csrc/ifft_fused.cu``) runs the four-step split
N = n2 * n1 = 128 * n1 of each block in one launch, on a cluster of four
thread blocks (eight for n1 = 448) that hold the block in their shared
memory together and exchange it there (block c of four: columns
[c*n1/4, (c+1)*n1/4), rows k2 [32c, 32c + 32)); nothing passes through
device memory between the steps, and only the kept output samples are
computed. Its plain version is
:func:`ska_pst_dsp_tpu_torch.ops.synthesis.epilogue`; its host tables come
from :func:`cluster_tables`.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import cfft
from ..synthesis import epilogue
from . import cluster_twiddles, kernel, launch, pass_twiddles, phase_table, query, require

#: the column transform length n2 the kernel takes (csrc/ifft_fused.cu kN2)
N2 = 128
#: row transform length n1 -> (r1, q1, thread blocks of a cluster), n1 =
#: r1 * q1: the kernel's instantiations (csrc/ifft_fused.cu cluster_dispatch)
PLANS = {128: (1, 128, 4), 192: (3, 64, 4), 384: (3, 128, 4), 448: (7, 64, 8)}
N1S = tuple(PLANS)
#: the N-level twiddle w_N^(m1*k2) = tw_a[k2 // 16, m1] * tw_b[k2 % 16, m1]
TW_SPLIT = 16


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


def takes(n2: int, n1: int) -> bool:
    """Whether the card has a cluster kernel for the split n = n2 * n1."""
    return n2 == N2 and n1 in PLANS


def cluster_tables(n: int, n1: int, roll: int) -> Dict[str, np.ndarray]:
    """The kernel's host tables, complex64, each built in float64 from exact
    integers: ``tw_pass`` (the per-pass table of the 128-point backward
    transform), :func:`..cluster_twiddles`' ``tw_n1``, ``tw_a`` and ``tw_b``
    at S = :data:`TW_SPLIT` ((8, n1) and (16, n1)); ``roll_row``,
    ``roll_col`` (w_N^(-roll*k2), w_N^(-roll*128*k1): the roll phase
    w_N^(-roll*t) of t = k2 + 128*k1 is their product)."""
    return {
        "tw_pass": pass_twiddles(N2, 1),
        **cluster_twiddles(n, N2, n1, TW_SPLIT),
        "roll_row": phase_table(roll * np.arange(N2), n, -1),
        "roll_col": phase_table(roll * N2 * np.arange(n1), n, -1),
    }


@functools.lru_cache(maxsize=None)
def _device_tables(n: int, n1: int, roll: int,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device)
            for k, v in cluster_tables(n, n1, roll).items()}


def active_clusters(n1: int = 384) -> int:
    """Clusters of the n1-point kernel resident on the current card at once
    (the persistent grid's size)."""
    return query("ifft_fused_clusters", torch.device("cuda"), n1)


@kernel("ifft_fused")
def fused_big_ifft(flat, elem=None, *, shape_key, n_valid: Optional[int] = None):
    """Fused IFFT(roll(X * elem, -roll)) * gain, keeping [lo, N-lo).

    flat: (n_pol, B, N) assembled spectra, complex or an (re, im) pair
    (same kind out); elem: optional (N,) factor, pre-rolled by +roll
    (ValueError for a (rows, N) table: no row of it is applied to every stream);
    shape_key: (n, n2, n1, lo, roll, gain) with n == n2 * n1. Returns
    (n_pol, n_valid, N - 2*lo); blocks past ``n_valid`` (default all) are
    never computed. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel, which takes n2 = 128 and n1 in :data:`N1S` and
    raises ValueError for any other split."""
    n, n2, n1, lo, roll, gain = shape_key
    x, pair = cfft.as_complex(flat)
    e = None if elem is None else cfft.as_complex(elem)[0]
    if e is not None and e.ndim != 1:
        raise ValueError(f"fused_big_ifft applies one (N,) elem to every stream, got "
                         f"{tuple(e.shape)}: a (rows, N) table runs on inversion_fused or "
                         f"the composed epilogue")
    if n_valid is None:
        n_valid = x.shape[1]
    if x.device.type == "cpu":
        return cfft.same_kind(epilogue(x, e, lo, roll, gain, n_valid), pair)
    if not takes(n2, n1):
        raise ValueError(f"the cluster epilogue takes n2 = {N2} and n1 in {N1S}, "
                         f"got ({n2}, {n1})")
    dev = x.device
    if x.dtype != torch.complex64:
        raise TypeError(f"flat must be complex64, got {x.dtype}")
    if x.ndim != 3 or x.shape[2] != n or n != n2 * n1:
        raise ValueError(f"flat must be (n_pol, B, {n}) with n = n2*n1")
    if not 0 < n_valid <= x.shape[1]:
        raise ValueError(f"n_valid={n_valid} outside [1, {x.shape[1]}]")
    if lo % n2 or (n - 2 * lo) <= 0 or (n - 2 * lo) % n2:
        raise ValueError(f"keep region [{lo}, {n - lo}) is not whole n2={n2} rows")
    # the bulk copies read 16-byte-aligned rows
    if x.stride(2) != 1 or x.stride(0) % 2 or x.stride(1) % 2 or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    if e is not None:
        e = require(e, "elem", torch.complex64, dev)
        if e.shape != (n,):
            raise ValueError(f"elem must be ({n},), got {tuple(e.shape)}")
    n_pol = x.shape[0]
    out = torch.empty((n_pol, n_valid, n - 2 * lo), dtype=torch.complex64, device=dev)
    tab = _device_tables(n, n1, roll % n, dev)
    launch(fused_big_ifft, "ifft_fused_launch", x,
           x.data_ptr(), None if e is None else e.data_ptr(), out.data_ptr(),
           *(tab[k].data_ptr() for k in ("tw_pass", "tw_n1", "tw_a", "tw_b",
                                          "roll_row", "roll_col")),
           x.stride(0), x.stride(1), n_pol, n_valid, n2, n1, lo // n2,
           (n - 2 * lo) // n2, gain / n)
    return cfft.same_kind(out, pair)
