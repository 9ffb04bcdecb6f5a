"""SKA-Low CBF heap-format reshaping.

The port's copy of :mod:`ska_pst_dsp_tpu.io.lowcbf`, the equivalent of the
reference's reshape_low_cbf_data.m:24-56: LowCBF
DADA files (INSTRUMENT=LowCBF) carry data as 32-sample heaps whose packets
are ordered time-fastest, then polarization, then channel within each heap
(FPT packet ordering). This converts the flat complex stream to the
framework's (n_pol, n_chan, n_dat) layout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

NSAMP_PER_HEAP = 32


def reshape_low_cbf_stream(flat: np.ndarray, n_pol: int, n_chan: int) -> np.ndarray:
    """Flat complex heap stream → (n_pol, n_chan, n_samp).

    Trailing partial heaps are dropped (the reference warns and `fix`es the
    heap count, reshape_low_cbf_data.m:33-37).
    """
    per_heap = NSAMP_PER_HEAP * n_pol * n_chan
    n_heap = flat.size // per_heap
    flat = flat[: n_heap * per_heap]
    # per heap: index = t + T*p + T*P*f  (t fastest) → heaps(h, f, p, t)
    heaps = flat.reshape(n_heap, n_chan, n_pol, NSAMP_PER_HEAP)
    # → (p, f, h, t) → (p, f, h*t)
    return np.ascontiguousarray(heaps.transpose(2, 1, 0, 3)).reshape(
        n_pol, n_chan, n_heap * NSAMP_PER_HEAP
    )


def flatten_low_cbf_stream(data: np.ndarray) -> np.ndarray:
    """Inverse of :func:`reshape_low_cbf_stream`: (P, F, T) → flat heap stream
    (used when writing LowCBF-format test vectors)."""
    n_pol, n_chan, n_dat = data.shape
    n_heap = n_dat // NSAMP_PER_HEAP
    data = data[:, :, : n_heap * NSAMP_PER_HEAP]
    heaps = data.reshape(n_pol, n_chan, n_heap, NSAMP_PER_HEAP)
    return np.ascontiguousarray(heaps.transpose(2, 1, 0, 3)).ravel()


def reshape_low_cbf_data(pft_data: np.ndarray, header: Dict[str, str]) -> np.ndarray:
    """Adapter used by :mod:`..io.dada` when INSTRUMENT=LowCBF: undo the
    generic TFP reshape and reinterpret the underlying stream as heaps."""
    n_pol = int(header.get("NPOL", 1))
    n_chan = int(header.get("NCHAN", 1))
    flat = pft_data.transpose(2, 1, 0).ravel()
    return reshape_low_cbf_stream(flat, n_pol, n_chan)
