"""Fused analysis PFB kernel: fold + DFT + derotation ramp in one launch.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas.analysis_fused`. The CUDA
kernel (``csrc/analysis_fused.cu``) walks over tiles of
:func:`tile_spectra` consecutive spectra with one persistent thread block
per SM. Each tile's input span arrives by asynchronous bulk copies into a
ring of two shared-memory buffers (the next span loads while the current
one is folded and transformed), the fold replaces the span by the folded
rows, the DFT runs as register radix-8 passes (``csrc/fft_reg.cuh``), and
the last pass writes the time-major (n_pol, nblocks, block) spectra once,
in channel order, times the ramp. The low geometry (block 256, 13 phases,
hop 192) has its own fold, which reads each staged sample once per residue
class of the hop.

Given a table of bins, the generic 256-point instance stores channel-major
instead: (n_pol, len(rows), nblocks), row i holding bin rows[i] of every
spectrum, staged through the span buffer as a (bin, spectrum) tile so that
a warp stores 32 consecutive spectra of one row. SKA-Low's PST cascade
asks for it (``models/two_stage.py``), so that its corner turns are views
and the LowCBF stage writes only its 216 kept bins; every other caller
stores time-major. Its plain version is
:func:`ska_pst_dsp_tpu_torch.ops.analysis.analysis_plain`.

The TPU kernel's Mosaic-only rules (staged shifted copies of the input,
block0 a multiple of nu) are not carried over. Its ``keep_padding``
handoff hands the synthesis a tail-padded stream plus the valid row count;
this kernel writes exactly ``nblocks`` rows, so the handoff is the stream
itself plus ``nblocks``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from .. import cfft
from ..analysis import _prep_filter, analysis_plain, ramp_table, stream
from . import SMEM_LIMIT, device_pass_twiddles, kernel, launch, radix, reg_plan, require, twiddles

#: blocks (channel counts) the kernel takes on the card: r * 2^k with r in
#: {1, 3}, 128 to 1024 (csrc/analysis_fused.cu pick_kernel)
BLOCKS = (128, 256, 384, 512, 768, 1024)
#: shared-memory header (barriers, buffer offsets, row offsets), and the
#: largest ramp staged in shared memory, in bytes
HEADER, RAMP_STAGE = 160, 16384
#: (step, phases) of the block-256 geometry with its own fold (SKA-Low's);
#: the channel-major store exists on the generic fold of block 256 alone
LOW_FOLD, CHANNEL_MAJOR_BLOCK = (192, 13), 256


def tile_spectra(block: int) -> int:
    """Consecutive spectra per tile (csrc/analysis_fused.cu tile_spectra)."""
    return 32 if block <= 256 else 16 if block <= 512 else 8


def smem_bytes(block: int, step: int, phases: int, period: int, stages: int = 2,
               channel_major: bool = False) -> int:
    """Shared memory of one thread block with ``stages`` span buffers: the
    header; each buffer holds a tile's span plus one sample (a copy that
    starts one sample early), its folded sub-rows of q + 1 points or, for
    the channel-major store, its (bin, spectrum) tile of block x (k + 1),
    whichever is largest; the pass table, w_block for r = 3, and the ramp
    where it is at most RAMP_STAGE bytes."""
    r, q, _ = radix(block)
    k = tile_spectra(block)
    span = (k - 1) * step + phases * block + 1
    tile = block * (k + 1) if channel_major else 0
    f2 = (max(span, k * r * (q + 1), tile) + 1) // 2 * 2
    ramp = period * block * 8
    return (HEADER + (stages * f2 + q - reg_plan(q)[1] + (block if r > 1 else 0)) * 8
            + (ramp if ramp <= RAMP_STAGE else 0))


def span_stages(block: int, step: int, phases: int, period: int,
                channel_major: bool = False) -> int:
    """Span buffers the kernel runs with: 2 where they fit in shared memory,
    else 1, else 0 (the geometry does not fit)."""
    return next((s for s in (2, 1)
                 if smem_bytes(block, step, phases, period, s, channel_major) <= SMEM_LIMIT),
                0)


class AnalysisPlan(NamedTuple):
    """What the launch needs of a geometry the kernel takes: block =
    r * 2^logq and the span buffers it runs with."""
    r: int
    logq: int
    stages: int


@functools.lru_cache(maxsize=None)
def plan(block: int, step: int, phases: int, period: int,
         channel_major: bool = False) -> Optional[AnalysisPlan]:
    """The kernel's plan, computed once per geometry and store, or None
    for one it does not take: the block must be one of :data:`BLOCKS` (the
    channel-major store: :data:`CHANNEL_MAJOR_BLOCK`, not at
    :data:`LOW_FOLD`) and one span buffer must fit in shared memory."""
    if block not in BLOCKS or step <= 0 or phases <= 0 or period <= 0:
        return None
    if channel_major and (block != CHANNEL_MAJOR_BLOCK or (step, phases) == LOW_FOLD):
        return None
    stages = span_stages(block, step, phases, period, channel_major)
    if not stages:
        return None
    r, _, logq = radix(block)
    return AnalysisPlan(r, logq, stages)


def takes(block: int, step: int, phases: int, period: int,
          channel_major: bool = False) -> bool:
    """Whether the card has an analysis kernel for this geometry and store."""
    return plan(block, step, phases, period, channel_major) is not None


@kernel("analysis_fused", plain=analysis_plain)
def analysis_fused(x: torch.Tensor, f2d: torch.Tensor, ramp: torch.Tensor,
                   step: int, block0: int = 0,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_pol, n_dat) complex64 -> time-major (n_pol, nblocks, block), or
    given ``rows`` (an int32 table of bins, each below block, on x's
    device) channel-major (n_pol, len(rows), nblocks), row i holding bin
    rows[i] of every spectrum.

    f2d: (phases, block) float32 polyphase filter; ramp: (period, block)
    complex64 derotation table (:func:`..analysis.ramp_table`). A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel, which
    takes the geometries of :func:`takes` (the blocks in :data:`BLOCKS`
    whose span fits in shared memory; channel-major, block 256 on the
    generic fold) and raises ValueError for any other. Each channel-major
    launch also counts in ``analysis_fused.channel_major_launches``."""
    phases, block = f2d.shape
    if ramp.ndim != 2 or ramp.shape[1] != block:
        raise ValueError(f"ramp must be (period, {block}), got {tuple(ramp.shape)}")
    period = ramp.shape[0]
    cm = rows is not None
    p = plan(block, step, phases, period, cm)
    if p is None:
        raise ValueError(
            f"analysis_fused takes blocks {BLOCKS} on the card whose span fits in "
            f"shared memory (channel-major: block {CHANNEL_MAJOR_BLOCK}, not "
            f"{LOW_FOLD[1]} phases at step {LOW_FOLD[0]}), got {phases} phases x {block} at "
            f"step {step}{' channel-major' if cm else ''}"
        )
    dev = x.device
    if x.dtype != torch.complex64 or x.ndim != 2:
        raise TypeError(f"x must be a (n_pol, n_dat) complex64 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    f2d = require(f2d, "f2d", torch.float32, dev)
    ramp = require(ramp, "ramp", torch.complex64, dev)
    if cm:
        rows = require(rows, "rows", torch.int32, dev)
        if rows.ndim != 1 or not 0 < rows.shape[0] <= block:
            raise ValueError(f"rows must hold 1 to {block} bins, got {tuple(rows.shape)}")
    if block0 < 0:
        raise ValueError(f"block0 must be >= 0, got {block0}")
    r, logq = p.r, p.logq
    n_pol, n_dat = x.shape
    nblocks = (n_dat - phases * block) // step
    if nblocks <= 0:
        raise ValueError(
            f"input stream too short: {n_dat} samples yield {nblocks} spectra"
        )
    # a view whose samples are contiguous is read in place (a chunk of a
    # longer stream); the bulk copies start on 16 bytes of its base
    if x.stride(1) != 1 or x.data_ptr() % 16 or (n_pol > 1 and x.stride(0) < n_dat):
        x = x.clone(memory_format=torch.contiguous_format)
    pol_stride = x.stride(0) if n_pol > 1 else n_dat
    shape = (n_pol, rows.shape[0], nblocks) if cm else (n_pol, nblocks, block)
    out = torch.empty(shape, dtype=torch.complex64, device=dev)
    tw_pass = device_pass_twiddles(1 << logq, -1, dev)
    tw_n = twiddles(block, -1, dev) if r > 1 else tw_pass
    launch(analysis_fused, "analysis_fused_launch", x,
           x.data_ptr(), out.data_ptr(), f2d.data_ptr(), tw_pass.data_ptr(),
           tw_n.data_ptr(), ramp.data_ptr(), rows.data_ptr() if cm else None, n_pol, n_dat,
           pol_stride, nblocks, block, r, logq, step, phases, period, block0 % period,
           rows.shape[0] if cm else 0, SMEM_LIMIT)
    analysis_fused.channel_major_launches += int(cm)
    return out


#: channel-major launches since the process began (each also counts in
#: ``launches``)
analysis_fused.channel_major_launches = 0


def polyphase_analysis_fused(x, filt, block: int, os_factor, *,
                             block0: int = 0, time_major: bool = False,
                             keep_padding: bool = False):
    """Fused single-stage analysis PFB (drop-in for
    :func:`..analysis.polyphase_analysis`). Complex/pair in -> same kind out.

    ``time_major=True`` returns (n_pol, nblocks, block), the input layout
    of the fused synthesis. ``keep_padding=True`` (pair input and
    time_major only) returns ``((re, im), nblocks)`` to hand to
    ``polyphase_synthesis_fused(..., time_major_in=True,
    valid_len=nblocks)``.

    On the card a geometry the kernel does not take (:func:`takes`) raises
    ValueError, as :func:`analysis_fused` does."""
    z, pair = stream(x)
    os_factor = Rational.coerce(os_factor)
    step = geometry.analysis_step(block, os_factor)
    f2d = torch.as_tensor(_prep_filter(filt, block), device=z.device)
    ramp = torch.as_tensor(ramp_table(block, step), device=z.device)
    out = analysis_fused(z, f2d, ramp, step, block0)
    if keep_padding:
        if not (pair and time_major):
            raise ValueError(
                "keep_padding requires tuple input and time_major=True"
            )
        return (out.real, out.imag), out.shape[1]
    if not time_major:
        out = out.transpose(1, 2)
    return cfft.same_kind(out, pair)
