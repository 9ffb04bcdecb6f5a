"""Fused zero-padded (SKA-Mid) analysis: the fold kernel and the public
padded analysis built on it.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas.analysis_padded_fused`.
The CUDA kernel (``csrc/analysis_padded_fused.cu``) stages, for K
consecutive spectra and C columns of the stream's W-row view, only the rows
their fold terms touch, treats samples before the stream start as zeros
(no padded copy of the input) and writes the unreversed fold rows
time-major. Its plain version is
:func:`ska_pst_dsp_tpu_torch.ops.analysis.padded_fold`.

The TPU kernel's aligned-fold phase (``d == 8``: spectra stored cyclically
advanced, undone by a factor in the ramp constant) is a sublane layout rule
and is not carried over: this fold stores true rows, so the channel-DFT
constant is :func:`..analysis.padded_chan_const` with no such factor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from .. import cfft
from ..analysis import _prep_filter, padded_chan_const, padded_fold, stream
from . import SMEM_LIMIT, _build, require, stream_of
from .chan_dft_fused import chan_dft_ramp

#: consecutive spectra and W-row columns per thread block
#: (csrc/analysis_padded_fused.cu kSpec, kCols)
K_TILE, C_TILE = 32, 32


def fold_rows(block: int, step: int):
    """(W, D, S): the W-row view of the stream, W = gcd(step, block), with
    block = D*W and step = S*W."""
    w = math.gcd(step, block)
    return w, block // w, step // w


def smem_bytes(block: int, step: int, phases: int) -> int:
    """Shared memory of one thread block: S*(K-1) + D*phases staged rows of
    C_TILE columns."""
    _, d, s = fold_rows(block, step)
    return (s * (K_TILE - 1) + d * phases) * C_TILE * 8


def padded_fold_fused(x: torch.Tensor, f2d_rev: torch.Tensor, step: int) -> torch.Tensor:
    """(n_pol, n_dat) complex64 -> time-major (n_pol, n_dat // step, block)
    unreversed fold rows. f2d_rev: (phases, block) float32, the reversed
    filter. A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel."""
    if x.device.type == "cpu":
        return padded_fold(x, f2d_rev, step)
    if x.device.type != "cuda":
        raise ValueError(f"padded_fold_fused runs on cuda or cpu, not {x.device}")
    dev = x.device
    x = require(x, "x", torch.complex64, dev)
    f2d_rev = require(f2d_rev, "f2d_rev", torch.float32, dev)
    if x.ndim != 2:
        raise ValueError(f"x must be (n_pol, n_dat), got {tuple(x.shape)}")
    phases, block = f2d_rev.shape
    w, d, s = fold_rows(block, step)
    if w % C_TILE:
        raise ValueError(
            f"padded fold needs gcd(step, block) a multiple of {C_TILE}, got {w}"
        )
    if smem_bytes(block, step, phases) > SMEM_LIMIT:
        raise ValueError(
            f"padded fold rows of {phases} phases x {block} at step {step} do "
            "not fit in shared memory"
        )
    n_pol, n_dat = x.shape
    nblocks = n_dat // step
    if nblocks <= 0:
        raise ValueError(f"input stream too short: {n_dat} samples < step {step}")
    g = torch.empty((n_pol, nblocks, block), dtype=torch.complex64, device=dev)
    with torch.cuda.device(dev):
        status = _build.library().padded_fold_launch(
            x.data_ptr(), g.data_ptr(), f2d_rev.data_ptr(), n_pol, n_dat, nblocks,
            block, w, d, s, phases, stream_of(x),
        )
    _build.check(status, "padded_fold_fused")
    padded_fold_fused.launches += 1
    return g


padded_fold_fused.launches = 0


def polyphase_analysis_padded_fused(x, filt, block: int, os_factor, *,
                                    block0: int = 0, apply_delay: bool = True,
                                    time_major: bool = False):
    """Fused zero-padded analysis PFB (drop-in for
    :func:`..analysis.polyphase_analysis_padded`): fold kernel, then the
    channel-DFT kernel with the ramp, ``block0`` and the group-delay roll.
    Complex/pair in -> same kind out; ``time_major=True`` returns
    (n_pol, n_dat // step, block), the fused synthesis' input layout."""
    z, pair = stream(x)
    os_factor = Rational.coerce(os_factor)
    step = geometry.analysis_step(block, os_factor)
    delay = (geometry.padded_sample_delay_shift(np.asarray(filt).size, block, os_factor)
             if apply_delay else 0)
    f2d_rev = torch.as_tensor(_prep_filter(filt, block, reverse=True), device=z.device)
    const = torch.as_tensor(padded_chan_const(block, step), device=z.device)
    g = padded_fold_fused(z, f2d_rev, step)
    out = chan_dft_ramp(g, const, block0, delay)
    if not time_major:
        out = out.transpose(1, 2)
    return cfft.same_kind(out, pair)
