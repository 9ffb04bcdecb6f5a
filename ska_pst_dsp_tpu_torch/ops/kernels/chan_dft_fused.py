"""Fused channel DFT + derotation constant of the padded (SKA-Mid) analysis.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas.chan_dft_fused`. The CUDA
kernel (``csrc/chan_dft_fused.cu``) FFTs a few fold rows in shared memory,
multiplies each bin by its constant row (:func:`..analysis.padded_chan_const`)
and writes the spectrum in channel order to the row the group-delay roll
sends it to. Its plain version is
:func:`ska_pst_dsp_tpu_torch.ops.analysis.chan_dft_core`.
"""

from __future__ import annotations

import torch

from ..analysis import chan_dft_core
from . import SMEM_LIMIT, _build, radix, require, stream_of, twiddles

#: spectra per thread block (csrc/chan_dft_fused.cu kRows)
ROWS = 2


def chan_dft_ramp(g: torch.Tensor, const: torch.Tensor, block0: int = 0,
                  delay: int = 0) -> torch.Tensor:
    """(n_pol, nb, block) complex64 fold rows -> (n_pol, nb, block):
    FFT(g_k) * const[(k + block0) % nu], row k stored at (k - delay) mod nb.
    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel."""
    if g.device.type == "cpu":
        return chan_dft_core(g, const, block0, delay)
    if g.device.type != "cuda":
        raise ValueError(f"chan_dft_ramp runs on cuda or cpu, not {g.device}")
    dev = g.device
    g = require(g, "g", torch.complex64, dev)
    const = require(const, "const", torch.complex64, dev)
    if g.ndim != 3:
        raise ValueError(f"g must be (n_pol, nb, block), got {tuple(g.shape)}")
    n_pol, nb, block = g.shape
    if const.ndim != 2 or const.shape[1] != block:
        raise ValueError(f"const must be (nu, {block}), got {tuple(const.shape)}")
    if block0 < 0:
        raise ValueError(f"block0 must be >= 0, got {block0}")
    if ROWS * block * 8 > SMEM_LIMIT:
        raise ValueError(f"{ROWS} spectra of {block} do not fit in shared memory")
    r, q, logq = radix(block)
    out = torch.empty_like(g)
    tab = twiddles(block, -1, dev)
    with torch.cuda.device(dev):
        status = _build.library().chan_dft_launch(
            g.data_ptr(), out.data_ptr(), tab.data_ptr(), const.data_ptr(), n_pol,
            nb, block, r, q, logq, const.shape[0], block0, delay % nb, stream_of(g),
        )
    _build.check(status, "chan_dft_ramp")
    chan_dft_ramp.launches += 1
    return out


chan_dft_ramp.launches = 0
