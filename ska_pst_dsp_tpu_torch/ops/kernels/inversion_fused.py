"""Fused SKA-Low Golden inversion: frontend and epilogue in one kernel.

At the SKA-Low inversion geometry (L = 256, 256 channels, FN_width = 192,
N = 49152 = 128 * 384) the CUDA kernel (``csrc/inversion_fused.cu``) runs
:mod:`.synthesis_fused`'s frontend and :mod:`.ifft_fused`'s cluster
epilogue together: a cluster of eight thread blocks, each the frontend of
32 channels, stores each assembled block's bins straight into the column
buffers of the cluster's blocks (distributed shared memory) and runs the
epilogue there, so the assembled spectra never pass through device memory.
Every other geometry keeps the two kernels (:func:`takes` decides). Its
plain version is :func:`ska_pst_dsp_tpu_torch.ops.synthesis.frontend`
followed by :func:`ska_pst_dsp_tpu_torch.ops.synthesis.epilogue`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ska_pst_dsp_tpu_torch.utils.profiling import spanned

from ..synthesis import epilogue, frontend
from . import _build, require, stream_of, twiddles
from .ifft_fused import _device_tables, plan_ifft

#: the geometry the kernel is instantiated for (csrc/inversion_fused.cu):
#: (frame length L, channels, points of an assembled block), FN_width = 192
GEOMETRY = (256, 256, 49152)
#: the (n2, n1) split of the block the kernel runs
SPLIT = (128, 384)


@functools.lru_cache(maxsize=None)
def takes(L: int, n_chan: int, n: int, lo: int) -> bool:
    """Whether the card has the fused kernel for an inversion with frame
    length L, n_chan channels, n-point blocks and output overlap lo: the
    SKA-Low geometry, where :func:`.ifft_fused.plan_ifft` splits the block
    as (128, 384). Kept per geometry: a call costs a dictionary lookup."""
    return (L, n_chan, n) == GEOMETRY and plan_ifft(n, lo) == SPLIT


def active_clusters() -> int:
    """Clusters of eight blocks of the kernel resident on the current card
    at once (the persistent grid's size)."""
    clusters = ctypes.c_int(0)
    _build.check(_build.library().inversion_fused_clusters(ctypes.byref(clusters)),
                 "inversion_fused_clusters")
    return clusters.value


@spanned("kernel.inversion_fused")
def inversion_fused(x_tc: torch.Tensor, t_taper: torch.Tensor, dr: torch.Tensor,
                    perm: torch.Tensor, elem: Optional[torch.Tensor], keep: int,
                    kpos: int, n_blocks: int, lo: int, roll: int,
                    gain: float) -> torch.Tensor:
    """(n_pol, n_dat, n_chan) complex64, any strides -> (n_pol, n_blocks,
    N - 2*lo): the frontend (output channel c reads input channel perm[c];
    kept bin j is raw DFT bin (kpos + j) mod L times dr[j]) then
    IFFT(roll(X * elem, -roll))[lo:N-lo] * gain of each assembled block, with
    elem (N,) pre-rolled by +roll or None. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel, which takes the geometry of
    :func:`takes` only and raises ValueError for any other."""
    n_pol, n_dat, n_chan = x_tc.shape
    L, fnw = t_taper.shape[0], dr.shape[0]
    n = n_chan * fnw
    if x_tc.device.type == "cpu":
        fn = frontend(x_tc, t_taper, dr, perm, L, keep, kpos, n_blocks)
        return epilogue(fn.reshape(n_pol, n_blocks, n), elem, lo, roll, gain, n_blocks)
    if not takes(L, n_chan, n, lo):
        raise ValueError(
            "inversion_fused takes (L, channels, points) = {} split {}; got {}, "
            "overlap {}".format(GEOMETRY, SPLIT, (L, n_chan, n), lo)
        )
    if x_tc.device.type != "cuda":
        raise ValueError(f"inversion_fused runs on cuda or cpu, not {x_tc.device}")
    dev = x_tc.device
    if x_tc.dtype != torch.complex64:
        raise TypeError("x must be a (n_pol, n_dat, n_chan) complex64 tensor")
    t_taper = require(t_taper, "t_taper", torch.float32, dev)
    dr = require(dr, "dr", torch.float32, dev)
    perm = require(perm, "perm", torch.int32, dev)
    if perm.shape != (n_chan,):
        raise ValueError("perm must be (n_chan,)")
    if n_blocks <= 0 or (n_blocks - 1) * keep + L > n_dat:
        raise ValueError(
            f"{n_blocks} overlap-save blocks of {L} at hop {keep} do not fit "
            f"in {n_dat} samples"
        )
    if elem is not None:
        elem = require(elem, "elem", torch.complex64, dev)
        if elem.shape != (n,):
            raise ValueError(f"elem must be ({n},), got {tuple(elem.shape)}")
    n2, n1 = SPLIT
    out = torch.empty((n_pol, n_blocks, n - 2 * lo), dtype=torch.complex64, device=dev)
    tab = _device_tables(n, n1, roll % n, dev)
    sp, st, sc = x_tc.stride()
    with torch.cuda.device(dev):
        status = _build.library().inversion_fused_launch(
            x_tc.data_ptr(), None if elem is None else elem.data_ptr(), out.data_ptr(),
            t_taper.data_ptr(), dr.data_ptr(), perm.data_ptr(), twiddles(L, -1, dev).data_ptr(),
            *(tab[k].data_ptr() for k in ("tw_pass", "tw_n1", "tw_a", "tw_b")),
            sp, st, sc, n_pol, n_chan, n_blocks, L, keep, kpos % L, roll % n, fnw,
            lo // n2, (n - 2 * lo) // n2, gain / n, stream_of(x_tc),
        )
    _build.check(status, "inversion_fused")
    inversion_fused.launches += 1
    return out


inversion_fused.launches = 0
