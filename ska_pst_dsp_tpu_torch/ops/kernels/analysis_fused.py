"""Fused analysis PFB kernel: fold + DFT + derotation ramp in one launch.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas.analysis_fused`. The CUDA
kernel (``csrc/analysis_fused.cu``) stages the input span of K consecutive
spectra in shared memory, folds, FFTs and derotates them there, and writes
the time-major (n_pol, nblocks, block) spectra once. Its plain version is
:func:`ska_pst_dsp_tpu_torch.ops.analysis.analysis_core`.

The TPU kernel's Mosaic-only rules (``block % 128 == 0``, staged shifted
copies of the input, block0 a multiple of nu) are not carried over. Its
``keep_padding`` handoff hands the synthesis a tail-padded stream plus the
valid row count; this kernel writes exactly ``nblocks`` rows, so the
handoff is the stream itself plus ``nblocks``.
"""

from __future__ import annotations

import torch

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from .. import cfft
from ..analysis import _prep_filter, analysis_core, ramp_table, stream
from . import SMEM_LIMIT, _build, radix, require, stream_of, twiddles

#: consecutive spectra per thread block (csrc/analysis_fused.cu K)
K_TILE = 32


def smem_bytes(block: int, step: int, phases: int) -> int:
    """Shared memory of one thread block: the staged input span of K_TILE
    spectra, whose storage the folded rows reuse."""
    span = (K_TILE - 1) * step + phases * block
    return max(span, K_TILE * block) * 8


def analysis_fused(x: torch.Tensor, f2d: torch.Tensor, ramp: torch.Tensor,
                   step: int, block0: int = 0) -> torch.Tensor:
    """(n_pol, n_dat) complex64 -> time-major (n_pol, nblocks, block).

    f2d: (phases, block) float32 polyphase filter; ramp: (period, block)
    complex64 derotation table (:func:`..analysis.ramp_table`). A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return analysis_core(x, f2d, ramp, step, block0)
    if x.device.type != "cuda":
        raise ValueError(f"analysis_fused runs on cuda or cpu, not {x.device}")
    dev = x.device
    x = require(x, "x", torch.complex64, dev)
    f2d = require(f2d, "f2d", torch.float32, dev)
    ramp = require(ramp, "ramp", torch.complex64, dev)
    if x.ndim != 2:
        raise ValueError(f"x must be (n_pol, n_dat), got {tuple(x.shape)}")
    phases, block = f2d.shape
    if block > 1024:
        raise ValueError(f"analysis_fused takes block <= 1024, got {block}")
    if ramp.ndim != 2 or ramp.shape[1] != block:
        raise ValueError(f"ramp must be (period, {block}), got {tuple(ramp.shape)}")
    if block0 < 0:
        raise ValueError(f"block0 must be >= 0, got {block0}")
    if smem_bytes(block, step, phases) > SMEM_LIMIT:
        raise ValueError(
            f"analysis span of {phases} phases x {block} at step {step} does "
            "not fit in shared memory"
        )
    r, q, logq = radix(block)
    n_pol, n_dat = x.shape
    nblocks = (n_dat - phases * block) // step
    if nblocks <= 0:
        raise ValueError(
            f"input stream too short: {n_dat} samples yield {nblocks} spectra"
        )
    out = torch.empty((n_pol, nblocks, block), dtype=torch.complex64, device=dev)
    tab = twiddles(block, -1, dev)
    with torch.cuda.device(dev):
        status = _build.library().analysis_fused_launch(
            x.data_ptr(), out.data_ptr(), f2d.data_ptr(), tab.data_ptr(),
            ramp.data_ptr(), n_pol, n_dat, nblocks, block, r, q, logq, step,
            phases, ramp.shape[0], block0, stream_of(x),
        )
    _build.check(status, "analysis_fused")
    analysis_fused.launches += 1
    return out


analysis_fused.launches = 0


def polyphase_analysis_fused(x, filt, block: int, os_factor, *,
                             block0: int = 0, time_major: bool = False,
                             keep_padding: bool = False):
    """Fused single-stage analysis PFB (drop-in for
    :func:`..analysis.polyphase_analysis`). Complex/pair in -> same kind out.

    ``time_major=True`` returns (n_pol, nblocks, block), the input layout
    of the fused synthesis. ``keep_padding=True`` (pair input and
    time_major only) returns ``((re, im), nblocks)`` to hand to
    ``polyphase_synthesis_fused(..., time_major_in=True,
    valid_len=nblocks)``."""
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
