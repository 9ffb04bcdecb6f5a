"""Sliding-window framing as a strided view.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.framing`. The JAX module builds
frames from static slices because a gather is slow on the TPU; in PyTorch
``Tensor.unfold`` gives the overlapping frames as a view, with no copy.
"""

from __future__ import annotations

import torch


def frame(x: torch.Tensor, window: int, hop: int, n_frames: int) -> torch.Tensor:
    """Return frames[..., k, :] = x[..., k*hop : k*hop + window] for
    k in [0, n_frames), as a view of ``x``.

    x: (..., n_dat) with n_dat >= (n_frames-1)*hop + window.
    Returns (..., n_frames, window).
    """
    if n_frames <= 0:
        raise ValueError(
            f"input stream too short: {x.shape[-1]} samples yield "
            f"{n_frames} windows of {window} at hop {hop}"
        )
    n_dat = x.shape[-1]
    if n_dat < (n_frames - 1) * hop + window:
        raise ValueError(
            f"stream of {n_dat} too short for {n_frames} frames of "
            f"{window} at hop {hop}"
        )
    return x.unfold(-1, window, hop)[..., :n_frames, :]
