"""Fused Golden inversion: frontend and epilogue in one kernel.

At the three geometries it is instantiated for (:data:`GEOMETRIES`:
FN_width = 3L/4; SKA-Low's 256 channels at L = 256 and a LowCBF PST slab's
216 kept channels at L = 256 and 512; any output overlap of whole rows of
the split, such as the wider discard a coherently dedispersing PST node
takes) the CUDA kernel
(``csrc/inversion_fused.cu``) runs :mod:`.synthesis_fused`'s frontend and
the epilogue together: a cluster of eight thread blocks, each the frontend
of an eighth of the channels, stores each assembled block's bins straight
into the column buffers of the cluster's blocks (distributed shared
memory) and runs the four-step inverse transform there, so the assembled
spectra never pass through device memory. Its input may lie in two
tensors, a stream's held samples and its new block (``held``), read across
the seam where they lie, so that a streaming inversion joins nothing.
Every other geometry keeps the frontend kernel and its epilogue
(:func:`takes` decides). Its plain version is
:func:`ska_pst_dsp_tpu_torch.ops.synthesis.frontend` followed by
:func:`ska_pst_dsp_tpu_torch.ops.synthesis.epilogue`.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from ..synthesis import epilogue, frontend
from . import cluster_twiddles, kernel, launch, pass_twiddles, query, require, twiddles

#: (frame length L, channels, points N of an assembled block) -> the
#: (n2, n1) split of the block: the geometries the kernel is instantiated
#: for (csrc/inversion_fused.cu InvPlan), FN_width = 3L/4
GEOMETRIES = {
    (256, 256, 49152): (128, 384),  # SKA-Low
    (256, 216, 41472): (216, 192),  # a LowCBF PST slab: 216 kept channels
    (512, 216, 82944): (216, 384),  # the slab at L 512, a PST node's longer frame
}
#: n2 -> S of the N-level twiddle w_N^(m1*k2) = tw_a[k2 // S, m1] * tw_b[k2 % S, m1]
TW_SPLIT = {128: 16, 216: 36}


def takes(L: int, n_chan: int, n: int, lo: int) -> bool:
    """Whether the card has the fused kernel for an inversion with frame
    length L, n_chan channels, n-point blocks and output overlap lo: one of
    :data:`GEOMETRIES`, discarding whole rows of its split (lo a multiple
    of n2) and keeping some."""
    split = GEOMETRIES.get((L, n_chan, n))
    return split is not None and lo % split[0] == 0 and 0 <= 2 * lo < n


def radix6_pass_twiddles(q: int, sign: int) -> np.ndarray:
    """The per-pass twiddle table of a q = 6^k-point transform of sign
    ``sign`` on radix-6 passes (csrc/inversion_fused.cu, the 216-point
    column transform): for each pass s but the last, of span h = q / 6^(s+1),
    5 rows d = 1..5 of h entries exp(sign * 2*pi*i*j*d/(6h)), j < h.
    complex64, each angle taken in float64 from the exact integer j*d;
    q - 6 entries."""
    parts, h = [], q // 6
    while h > 1:
        jd = np.arange(1, 6)[:, None] * np.arange(h)[None, :]
        parts.append(np.exp(sign * 2j * np.pi * jd / (6 * h)).ravel())
        h //= 6
    out = np.concatenate(parts).astype(np.complex64)
    assert out.size == q - 6
    return out


def kernel_tables(n: int, n2: int, n1: int) -> Dict[str, np.ndarray]:
    """The kernel's host tables of the split n = n2 * n1, complex64, each
    built in float64 from exact integers, all backward: ``tw_col`` (the
    column transform's per-pass table: 128 points on radix-8 passes, 216 on
    radix-6 passes), :func:`..cluster_twiddles`' ``tw_n1``, ``tw_a`` and
    ``tw_b`` at S = :data:`TW_SPLIT` and ``tw_row`` (the 128-point per-pass
    table, whose first pass the row transform's radix-8 step reads). At
    SKA-Low they are :func:`.ifft_fused.cluster_tables`' ``tw_pass``,
    ``tw_n1``, ``tw_a``, ``tw_b``."""
    return {
        "tw_col": pass_twiddles(n2, 1) if n2 == 128 else radix6_pass_twiddles(n2, 1),
        **cluster_twiddles(n, n2, n1, TW_SPLIT[n2]),
        "tw_row": pass_twiddles(128, 1),
    }


@functools.lru_cache(maxsize=None)
def _device_tables(n: int, n2: int, n1: int, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in kernel_tables(n, n2, n1).items()}


def frame_lengths(n_chan: int) -> Dict[int, int]:
    """Frame length L -> points N of the kernel's plans for n_chan
    channels (none for a channel count it has no plan for)."""
    return {L: n for L, c, n in sorted(GEOMETRIES) if c == n_chan}


def active_clusters(n_chan: int = 256, L: int = 256) -> int:
    """Clusters of eight blocks of the kernel of frame length L and n_chan
    channels resident on the current card at once (the persistent grid's
    size): a plan's own, as its shared memory allows two blocks an SM or
    one."""
    return query("inversion_fused_clusters", torch.device("cuda"), L, n_chan)


@kernel("inversion_fused")
def inversion_fused(x_tc: torch.Tensor, t_taper: torch.Tensor, dr: torch.Tensor,
                    perm: torch.Tensor, elem: Optional[torch.Tensor], keep: int,
                    kpos: int, n_blocks: int, lo: int, roll: int,
                    gain: float, held: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_pol, n_dat, n_chan) complex64, any strides -> (n_pol, n_blocks,
    N - 2*lo): the frontend (output channel c reads input channel perm[c];
    kept bin j is raw DFT bin (kpos + j) mod L times dr[j]) then
    IFFT(roll(X * elem, -roll))[lo:N-lo] * gain of each assembled block, with
    elem pre-rolled by +roll or None: (N,), or a (rows, N) table whose row
    ``p % rows`` stream p reads (n_pol a multiple of rows). ``held``: None,
    or a (n_pol, h, n_chan) complex64 view, any strides, of the samples
    that come before x_tc's: the input is then held's h samples followed by
    x_tc's, which the kernel reads where they lie, across the seam (each such
    launch with h > 0 also counts in ``inversion_fused.split_launches``). A CPU tensor
    runs the plain version (on the two joined); a CUDA tensor launches the
    kernel, which takes the geometry of :func:`takes` only and raises
    ValueError for any other."""
    n_pol, n_dat, n_chan = x_tc.shape
    L, fnw = t_taper.shape[0], dr.shape[0]
    n = n_chan * fnw
    if x_tc.device.type == "cpu":
        if held is not None:
            x_tc = torch.cat([held, x_tc], dim=1)
        fn = frontend(x_tc, t_taper, dr, perm, L, keep, kpos, n_blocks)
        return epilogue(fn.reshape(n_pol, n_blocks, n), elem, lo, roll, gain, n_blocks)
    if not takes(L, n_chan, n, lo):
        raise ValueError(
            f"inversion_fused takes (L, channels, points) in {sorted(GEOMETRIES)} with an "
            f"output overlap of whole rows (n2) that keeps some; got {(L, n_chan, n, lo)}"
        )
    dev = x_tc.device
    if x_tc.dtype != torch.complex64:
        raise TypeError("x must be a (n_pol, n_dat, n_chan) complex64 tensor")
    h = 0
    if held is not None:
        if held.dtype != torch.complex64 or held.device != dev:
            raise TypeError(f"held must be complex64 on {dev}")
        if held.ndim != 3 or held.shape[0] != n_pol or held.shape[2] != n_chan:
            raise ValueError(f"held must be ({n_pol}, h, {n_chan}), got {tuple(held.shape)}")
        h = held.shape[1]
    t_taper = require(t_taper, "t_taper", torch.float32, dev)
    dr = require(dr, "dr", torch.float32, dev)
    perm = require(perm, "perm", torch.int32, dev)
    if perm.shape != (n_chan,):
        raise ValueError("perm must be (n_chan,)")
    if n_blocks <= 0 or (n_blocks - 1) * keep + L > h + n_dat:
        raise ValueError(
            f"{n_blocks} overlap-save blocks of {L} at hop {keep} do not fit "
            f"in {h + n_dat} samples"
        )
    rows = 1
    if elem is not None:
        elem = require(elem, "elem", torch.complex64, dev)
        rows = elem.shape[0] if elem.ndim == 2 else 1
        if elem.ndim not in (1, 2) or elem.shape[-1] != n or rows == 0 or n_pol % rows:
            raise ValueError(f"elem must be ({n},) or (rows, {n}) with {n_pol} streams a "
                             f"multiple of rows, got {tuple(elem.shape)}")
    n2, n1 = GEOMETRIES[(L, n_chan, n)]
    out = torch.empty((n_pol, n_blocks, n - 2 * lo), dtype=torch.complex64, device=dev)
    tab = _device_tables(n, n2, n1, dev)
    launch(inversion_fused, "inversion_fused_launch", x_tc,
           x_tc.data_ptr(), None if held is None else held.data_ptr(),
           None if elem is None else elem.data_ptr(), out.data_ptr(),
           t_taper.data_ptr(), dr.data_ptr(), perm.data_ptr(), twiddles(L, -1, dev).data_ptr(),
           *(tab[k].data_ptr() for k in ("tw_col", "tw_n1", "tw_a", "tw_b", "tw_row")),
           *x_tc.stride(), *(held.stride() if held is not None else (0, 0, 0)), h,
           n_pol, n_chan, n_blocks, L, rows, keep, kpos % L, roll % n, fnw,
           lo // n2, (n - 2 * lo) // n2, gain / n)
    inversion_fused.split_launches += h > 0
    return out


#: launches whose input lay in two tensors, held samples and a new block
#: (each also counts in ``launches``)
inversion_fused.split_launches = 0
