"""Fused zero-padded (SKA-Mid) analysis: the fold kernel and the public
padded analysis built on it.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas.analysis_padded_fused`.
Every fold term sits on the stream's W-row view (:func:`fold_rows`):
spectrum k reads the D*phases rows before row S*k. The CUDA kernel
(``csrc/analysis_padded_fused.cu``) is one persistent launch. A work unit
is one polarization, C_TILE columns of the row view and a run of up to
``seg_tiles`` tiles of K_TILE spectra; a run's rows lie in shared memory in
stream order, the first tile loading its window of D*phases + S*(K_TILE-1)
rows (in whole boxes) and each later one only the S*K_TILE rows past it.
They arrive through a tensor map over the stream, a box of up to 256 rows
per asynchronous copy, issued one tile ahead of the fold; rows before the
stream start lie outside the tensor and arrive as zeros (no padded copy of
the input). At the mid geometry (25 phases, S = 7, D = 8) a thread reads
each staged value once per residue class of the spectra mod D, its
coefficients in registers; other geometries fold directly. The unreversed
fold rows are written time-major. Its plain version is
:func:`ska_pst_dsp_tpu_torch.ops.analysis.padded_fold`.

The TPU kernel's aligned-fold phase (``d == 8``: spectra stored cyclically
advanced, undone by a factor in the ramp constant) is a sublane layout rule
and is not carried over: this fold stores true rows, so the channel-DFT
constant is :func:`..analysis.padded_chan_const` with no such factor.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from .. import cfft
from ..analysis import _prep_filter, padded_chan_const, padded_fold, stream
from . import SMEM_LIMIT, chan_dft_fused, kernel, launch, query, require
from .chan_dft_fused import chan_dft_ramp

#: consecutive spectra per tile and W-row columns per work unit
#: (csrc/analysis_padded_fused.cu kSpec, kCols)
K_TILE, C_TILE = 32, 16
#: the shared-memory header (two barriers; keeps the rows on 128 bytes), in
#: bytes, and the most rows of a tensor-map box
HEADER, BOX_ROWS = 128, 256
#: (phases, S, D) with a residue-class fold of their own (pick_kernel)
SPECIALISED = ((25, 7, 8),)


def fold_rows(block: int, step: int):
    """(W, D, S): the W-row view of the stream, W = gcd(step, block), with
    block = D*W and step = S*W."""
    w = math.gcd(step, block)
    return w, block // w, step // w


class FoldPlan(NamedTuple):
    """The kernel's shared-memory plan of a geometry: the row view, the
    rows a tile reads (``window``), the rows each tile after a run's first
    adds (``slide``), the rows of one tensor-map box (the largest divisor
    of ``slide`` up to BOX_ROWS), the window in whole boxes (what a run's
    first tile loads) and the most tiles a run's rows fit in shared memory
    for."""
    w: int
    d: int
    s: int
    window: int
    slide: int
    box_rows: int
    window_pad: int
    max_tiles: int


def _rows(block: int, step: int, phases: int):
    """(w, d, s, window, slide, box_rows, window_pad) of a geometry, whether
    or not the kernel takes it."""
    w, d, s = fold_rows(block, step)
    window, slide = d * phases + s * (K_TILE - 1), s * K_TILE
    box_rows = next(b for b in range(min(slide, BOX_ROWS), 0, -1) if slide % b == 0)
    return w, d, s, window, slide, box_rows, -(-window // box_rows) * box_rows


@functools.lru_cache(maxsize=None)
def plan(block: int, step: int, phases: int) -> Optional[FoldPlan]:
    """The kernel's plan, or None for a geometry it does not take: W must
    be a multiple of C_TILE and one tile's boxes must fit in shared
    memory."""
    if block <= 0 or step <= 0 or phases <= 0:
        return None
    rows = _rows(block, step, phases)
    w, slide, window_pad = rows[0], rows[4], rows[6]
    buf_rows = (SMEM_LIMIT - HEADER) // (C_TILE * 8)
    if w % C_TILE or window_pad > buf_rows:
        return None
    return FoldPlan(*rows, 1 + (buf_rows - window_pad) // slide)


def takes(block: int, step: int, phases: int) -> bool:
    """Whether the card has a fold kernel for this geometry."""
    return plan(block, step, phases) is not None


@functools.lru_cache(maxsize=None)
def seg_tiles(p: FoldPlan, nblocks: int, lanes: int, slots: int) -> int:
    """Tiles per run for a stream of ``nblocks`` spectra whose every run is
    ``lanes`` work units (polarizations x column groups) on a card with
    ``slots`` resident thread blocks. Longer runs restage less, shorter
    ones spread more evenly: the count that fits whose busiest block
    stages the fewest rows (rounds of units x rows of a run), the longer
    run on a tie."""
    n_tiles = -(-nblocks // K_TILE)

    def rows_of_busiest(t: int) -> int:
        rounds = -(-lanes * -(-n_tiles // t) // slots)
        return rounds * (p.window_pad + p.slide * (t - 1))

    return min(range(min(p.max_tiles, n_tiles), 0, -1), key=rows_of_busiest)


@functools.lru_cache(maxsize=None)
def resident_blocks(p: FoldPlan, phases: int, device: torch.device) -> int:
    """Thread blocks of the geometry's kernel resident on the card at once:
    the size of the persistent grid, asked of the library that launches it
    (once per geometry and card)."""
    return query("padded_fold_slots", device, phases, p.s, p.d, SMEM_LIMIT)


def smem_bytes(block: int, step: int, phases: int, tiles: int = 1) -> int:
    """Shared memory of one thread block whose runs hold ``tiles`` tiles:
    the header and window_pad + (tiles - 1) * slide staged rows of C_TILE
    samples. The geometry need not be one the kernel takes."""
    _, _, _, _, slide, _, window_pad = _rows(block, step, phases)
    return HEADER + (window_pad + (tiles - 1) * slide) * C_TILE * 8


@kernel("analysis_padded_fused", plain=padded_fold)
def padded_fold_fused(x: torch.Tensor, f2d_rev: torch.Tensor, step: int) -> torch.Tensor:
    """(n_pol, n_dat) complex64 -> time-major (n_pol, n_dat // step, block)
    unreversed fold rows. f2d_rev: (phases, block) float32, the reversed
    filter. A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel, which takes the geometries of :func:`takes` and raises
    ValueError for any other."""
    phases, block = f2d_rev.shape
    p = plan(block, step, phases)
    if p is None:
        raise ValueError(
            f"padded fold of {phases} phases x {block} at step {step}: the card "
            f"needs gcd(step, block) a multiple of {C_TILE} and "
            f"{smem_bytes(block, step, phases)} <= {SMEM_LIMIT} bytes of shared memory"
        )
    dev = x.device
    if x.dtype != torch.complex64 or x.ndim != 2:
        raise TypeError("x must be a (n_pol, n_dat) complex64 tensor")
    f2d_rev = require(f2d_rev, "f2d_rev", torch.float32, dev)
    n_pol, n_dat = x.shape
    nblocks = n_dat // step
    if nblocks <= 0:
        raise ValueError(f"input stream too short: {n_dat} samples < step {step}")
    # the tensor map wants samples contiguous, the base and the polarization
    # stride on 16 bytes: any other view is copied into such a buffer
    if x.stride(1) != 1 or x.data_ptr() % 16 or (n_pol > 1 and x.stride(0) % 2):
        buf = torch.empty((n_pol, n_dat + n_dat % 2), dtype=x.dtype, device=dev)
        buf[:, :n_dat] = x
        x = buf[:, :n_dat]
    pol_stride = x.stride(0) if n_pol > 1 else n_dat + n_dat % 2
    if pol_stride < n_dat:
        raise ValueError("x's polarizations overlap in memory")
    g = torch.empty((n_pol, nblocks, block), dtype=torch.complex64, device=dev)
    tiles = seg_tiles(p, nblocks, n_pol * (p.w // C_TILE), resident_blocks(p, phases, dev))
    launch(padded_fold_fused, "padded_fold_launch", x,
           x.data_ptr(), g.data_ptr(), f2d_rev.data_ptr(), n_pol, n_dat, pol_stride,
           nblocks, block, p.w, p.d, p.s, phases, tiles, SMEM_LIMIT)
    return g


def polyphase_analysis_padded_fused(x, filt, block: int, os_factor, *,
                                    block0: int = 0, apply_delay: bool = True,
                                    time_major: bool = False):
    """Fused zero-padded analysis PFB (drop-in for
    :func:`..analysis.polyphase_analysis_padded`): fold kernel, then the
    channel-DFT kernel with the ramp, ``block0`` and the group-delay roll.
    Complex/pair in -> same kind out; ``time_major=True`` returns
    (n_pol, n_dat // step, block), the fused synthesis' input layout.

    On the card a geometry either kernel does not take (:func:`takes`,
    :func:`.chan_dft_fused.takes`) raises ValueError before anything is
    launched."""
    os_factor = Rational.coerce(os_factor)
    step = geometry.analysis_step(block, os_factor)
    z, pair = stream(x)
    if z.device.type != "cpu":  # refuse before the fold is launched
        chan_dft_fused.kernel_split(block)
    delay = (geometry.padded_sample_delay_shift(np.asarray(filt).size, block, os_factor)
             if apply_delay else 0)
    f2d_rev = torch.as_tensor(_prep_filter(filt, block, reverse=True), device=z.device)
    const = torch.as_tensor(padded_chan_const(block, step), device=z.device)
    g = padded_fold_fused(z, f2d_rev, step)
    out = chan_dft_ramp(g, const, block0, delay)
    if not time_major:
        out = out.transpose(1, 2)
    return cfft.same_kind(out, pair)
