"""A kind's least time on a card: the work's count, not the kernels'.

The rule every traffic kind follows (:meth:`pstbench.generator.Traffic.
least_seconds`): count the work the kind asks for itself, whatever kernels
implement it. Flops: the FFT-optimal count of the transforms it computes,
5 N log2 N a transform of N points (:func:`fft_flops`), 4 a filter tap (a
complex sample times a real tap), 6 a kept bin of a deripple. Bytes: 8 for
each complex64 sample read once and 8 for each written once, whatever the
kernels move in between, so 16 a sample where as many come out as go in.
So no implementation, however it is cut into kernels, can read above 100 %
of its least time.

The round trip (:func:`least_seconds`, every kind's default) counts as the
program's ``bench.roofline`` does, per complex input sample.

Peaks: NVIDIA's data sheets at the full power limit, by
``torch.cuda.get_device_name``; a card not in the table has no roofline.
"""

from __future__ import annotations

import math
from typing import Optional

from .reference import Geometry

#: bytes a complex input sample costs: read once, written once, complex64
BYTES_PER_SAMPLE = 16
#: (HBM bytes/s, fp32 flop/s outside the tensor cores) by card name
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),  # SXM5
    "NVIDIA H100 PCIe": (2.0e12, 51e12),
    "NVIDIA H100 NVL": (3.9e12, 60e12),
}


def fft_flops(n: int) -> float:
    """FFT-optimal flops of one complex transform of ``n`` points."""
    return 5.0 * n * math.log2(n)


def flops_per_sample(g: Geometry) -> float:
    """FFT-optimal flops of the round trip per complex input sample of one
    polarisation."""
    analysis = (4.0 * g.fl + fft_flops(g.n_chan)) / g.step
    block = g.n_chan * fft_flops(g.L) + 6.0 * g.n_chan * g.fn_width + fft_flops(g.n_out_fft)
    return analysis + block / g.out_keep


def seconds(flops: float, nbytes: float, device_name: str) -> Optional[float]:
    """The least time the card ``device_name`` could take over ``flops``
    and ``nbytes``: the larger of the flops over the fp32 peak and the
    bytes over the HBM peak. None for a card the table lacks."""
    if device_name not in PEAKS:
        return None
    hbm, fp32 = PEAKS[device_name]
    return max(flops / fp32, nbytes / hbm)


def least_seconds(g: Geometry, samples: int, device_name: str) -> Optional[float]:
    """:func:`seconds` of the round trip over ``samples`` complex input
    samples (all polarisations)."""
    return seconds(flops_per_sample(g) * samples, BYTES_PER_SAMPLE * samples, device_name)
