"""SKA-Low CBF firmware-model PST filterbank.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.lowcbf` (PSTFilterbank.m:7-45 and
polyphase_analysis_lowcbf.m:16-48): the 3072-tap / 256-channel / 12-tap FIR
filterbank at hop 192 that models the SKA-Low CBF FPGA firmware, keeping
the 216 = 256*27/32 critically sampled fine channels.

It is the single-stage analysis fold (12 phases of 256 at hop 192, with
``f2d[m, j] = filt[m*256 + j]``) followed by a 256-point DFT and a
per-bin factor that repeats every 4 spectra: the firmware's quarter-turn
de-rotation ``exp(2j*pi*mod(s*(-128:127), 4)/4)`` of the fftshifted bins.
So it runs on the analysis kernel (:func:`.kernels.analysis_fused.
analysis_fused`) with :func:`lowcbf_ramp` in place of the derotation ramp:
row ``s``, unshifted bin ``q`` holds the quarter turn of shifted bin
``(q + 128) % 256`` times the firmware's net scale, divided by the block
gain the kernel applies. The 216 kept channels are then gathered in
fftshifted (monotonic-frequency) order, or, stored channel-major, the
kernel writes those bins alone from the table :func:`kept_bins`. On a CPU
tensor the same call runs the kernel's plain version
(:func:`..analysis.analysis_plain`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import cfft
from .analysis import stream
from .kernels.analysis_fused import analysis_fused

NFILT = 3072
BLOCK = 256
STEP = 192
TAPS = 12
KEPT_LO = 20       # 0-based first kept channel (Matlab 21)
KEPT = 216
FIRST_CALL_PAD = 1536  # half the FIR length (PSTFilterbank.m:4-9)
#: firmware /2^9 (FIR) and /128 (FFT scaling), wrapper *2^9*2048*256
SCALE = (2.0**9 * 2048 * 256) / (2.0**9 * 128.0)


def _rotation_table() -> np.ndarray:
    """rot[s % 4, shifted_bin] = exp(2j*pi*((s * -(bin-128)) mod 4)/4),
    complex64 exact quarter turns."""
    quarter = np.array([1, 1j, -1, -1j], dtype=np.complex64)
    bins = np.arange(-128, 128)
    s = np.arange(4)[:, None]
    return quarter[(s * (-bins)) % 4]


def lowcbf_ramp() -> np.ndarray:
    """(4, 256) complex64 per-bin factor of the analysis kernel, in
    unshifted bin order: the quarter-turn table times SCALE / BLOCK (the
    kernel multiplies each spectrum by its block length)."""
    rot = _rotation_table()[:, (np.arange(BLOCK) + BLOCK // 2) % BLOCK]
    return (rot * np.float32(SCALE / BLOCK)).astype(np.complex64)


def kept_bins() -> np.ndarray:
    """(216,) unshifted DFT bins of the kept channels, in fftshifted order:
    channel c is bin (c + KEPT_LO + 128) % 256."""
    return (np.arange(KEPT) + KEPT_LO + BLOCK // 2) % BLOCK


def lowcbf_filter(filt) -> np.ndarray:
    """(12, 256) float32 fold coefficients, f2d[m, j] = filt[m*256 + j]."""
    return (np.asarray(filt, dtype=np.float64).ravel()[:NFILT]
            .reshape(TAPS, BLOCK).astype(np.float32))


def lowcbf_core(x: torch.Tensor, f2d: torch.Tensor, ramp: torch.Tensor,
                kept: torch.Tensor, first_call: bool, analysis=analysis_fused,
                channel_major: bool = False) -> torch.Tensor:
    """(n_pol, n_dat) complex64 -> time-major (n_pol, n_out, 216), or
    with ``channel_major`` the analysis's channel-major store of the kept
    bins, (n_pol, 216, n_out); n_out = (n_dat + pad - 3072) // 192 with pad
    = 1536 on the first call. f2d, ramp and kept (integer; int32 for the
    channel-major store) from :func:`lowcbf_filter`, :func:`lowcbf_ramp`
    and :func:`kept_bins`, on x's device; ``analysis`` is the kernel's
    wrapper or its plain version (``analysis_plain``)."""
    if first_call:
        x = torch.cat([x.new_zeros((x.shape[0], FIRST_CALL_PAD)), x], dim=-1)
    if channel_major:
        return analysis(x, f2d, ramp, STEP, rows=kept)
    return analysis(x, f2d, ramp, STEP).index_select(-1, kept)


def polyphase_analysis_lowcbf(x, filt, block: int = BLOCK, os_factor=None, *,
                              first_call: bool = True):
    """LowCBF firmware-model analysis (polyphase_analysis_lowcbf.m).

    The reference zero-pads 1536 samples only on the first call via Matlab
    ``persistent`` state; that state is explicit here (``first_call``).
    ``block`` and ``os_factor`` are accepted for the analysis functions'
    common signature; the firmware geometry is fixed.

    x: (n_pol, 1, n_dat) or (n_pol, n_dat) complex, or an (re, im) pair.
    Returns (n_pol, 216, n_out), the same kind as the input.
    """
    z, pair = stream(x)
    dev = z.device
    out = lowcbf_core(z, torch.as_tensor(lowcbf_filter(filt), device=dev),
                      torch.as_tensor(lowcbf_ramp(), device=dev),
                      torch.as_tensor(kept_bins(), device=dev), first_call)
    return cfft.same_kind(out.transpose(1, 2), pair)
