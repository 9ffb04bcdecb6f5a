"""The round trip's least time on a card: the work's count, not the kernels'.

Flops: the FFT-optimal count of the SKA PST round trip per complex input
sample, as the program's ``bench.roofline`` counts it: 5 N log2 N a
transform, 4 a filter tap (a complex sample times a real tap), 6 a kept bin
of the deripple. Bytes: 16 a sample, each input sample read once and each
output sample written once as complex64, whatever the kernels move in
between. So no implementation, however it is cut into kernels, can read
above 100 % of its least time.

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


def _fft(n: int) -> float:
    return 5.0 * n * math.log2(n)


def flops_per_sample(g: Geometry) -> float:
    """FFT-optimal flops per complex input sample of one polarisation."""
    analysis = (4.0 * g.fl + _fft(g.n_chan)) / g.step
    block = g.n_chan * _fft(g.L) + 6.0 * g.n_chan * g.fn_width + _fft(g.n_out_fft)
    return analysis + block / g.out_keep


def least_seconds(g: Geometry, samples: int, device_name: str) -> Optional[float]:
    """The least time the card ``device_name`` could take over ``samples``
    complex input samples (all polarisations): the larger of the flops
    over the fp32 peak and the bytes over the HBM peak. None for a card
    the table lacks."""
    if device_name not in PEAKS:
        return None
    hbm, fp32 = PEAKS[device_name]
    return max(flops_per_sample(g) * samples / fp32, BYTES_PER_SAMPLE * samples / hbm)
