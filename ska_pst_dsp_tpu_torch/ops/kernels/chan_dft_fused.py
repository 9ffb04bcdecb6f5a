"""Fused channel DFT + derotation constant of the padded (SKA-Mid) analysis.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas.chan_dft_fused`. The CUDA
kernel (``csrc/chan_dft_fused.cu``) runs each spectrum's forward FFT as
register radix-8 passes (``csrc/fft_reg.cuh``), the first loaded straight
from global memory, multiplies each bin by its constant row
(:func:`..analysis.padded_chan_const`) and stores the spectrum in channel
order, from registers, to the row the group-delay roll sends it to. Its
plain version is :func:`ska_pst_dsp_tpu_torch.ops.analysis.chan_dft_core`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..analysis import chan_dft_core
from . import device_pass_twiddles, kernel, launch, require, twiddles

#: block -> (r, log2 q), block = r * q: the lengths the kernel is
#: instantiated for (csrc/chan_dft_fused.cu pick_kernel). Every block the
#: JAX kernel takes (8 * b1, b1 a multiple of 128 and at most 512), and 512.
BLOCKS = {512: (1, 9), 1024: (1, 10), 2048: (1, 11), 3072: (3, 10), 4096: (1, 12)}
#: points per thread-block tile: 4096 / block spectra
POINTS = 4096


def takes(block: int) -> bool:
    """Whether the card has a channel-DFT kernel for this block."""
    return block in BLOCKS


def kernel_split(block: int) -> Tuple[int, int]:
    """(r, log2 q) of a block the kernel takes; ValueError for any other."""
    if not takes(block):
        raise ValueError(
            f"chan_dft_ramp takes blocks {sorted(BLOCKS)} on the card, got {block}"
        )
    return BLOCKS[block]


@kernel("chan_dft_fused", plain=chan_dft_core)
def chan_dft_ramp(g: torch.Tensor, const: torch.Tensor, block0: int = 0,
                  delay: int = 0) -> torch.Tensor:
    """(n_pol, nb, block) complex64 fold rows -> (n_pol, nb, block):
    FFT(g_k) * const[(k + block0) % nu], row k stored at (k - delay) mod nb.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel,
    which takes block in 512, 1024, 2048, 3072 and 4096 and raises
    ValueError for any other."""
    if g.ndim != 3:
        raise ValueError(f"g must be (n_pol, nb, block), got {tuple(g.shape)}")
    n_pol, nb, block = g.shape
    r, logq = kernel_split(block)
    dev = g.device
    g = require(g, "g", torch.complex64, dev)
    const = require(const, "const", torch.complex64, dev)
    if const.ndim != 2 or const.shape[1] != block:
        raise ValueError(f"const must be (nu, {block}), got {tuple(const.shape)}")
    if block0 < 0:
        raise ValueError(f"block0 must be >= 0, got {block0}")
    nu = const.shape[0]
    out = torch.empty_like(g)
    tw_pass = device_pass_twiddles(1 << logq, -1, dev)
    tw_n = twiddles(block, -1, dev) if r > 1 else tw_pass
    launch(chan_dft_ramp, "chan_dft_launch", g,
           g.data_ptr(), out.data_ptr(), tw_pass.data_ptr(), tw_n.data_ptr(),
           const.data_ptr(), n_pol, nb, block, r, logq, nu, block0 % nu, delay % nb)
    return out
