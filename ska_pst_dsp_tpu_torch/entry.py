"""Entry points of the port.

* :func:`low_round_trip` / :func:`entry`: the SKA-Low round trip at the
  geometry and input size of the JAX package's ``__graft_entry__.entry``:
  256 channels, OS 4/3, 3073-tap prototype filter (12 taps per channel),
  inversion L=256 / overlap 48 with tukey taper and deripple; 2 pol x 2^18
  samples of seeded noise.
* :func:`mid_round_trip`: the SKA-Mid round trip of
  ``config/test.config.json`` "mid" (bench.py ``bench_mid``): 4096
  channels, OS 8/7, the 100353-tap two-stage filter in the zero-padded
  analysis, inversion L=512 / overlap 128 with tukey taper and deripple.
"""

from __future__ import annotations

import numpy as np
import torch

from ska_pst_dsp_tpu_torch.design import fir
from ska_pst_dsp_tpu_torch.utils.config import load_config
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from .models.round_trip import PaddedPFBRoundTrip, PFBRoundTrip

N_CHAN, TAPS_PER_CHAN, L, OVERLAP = 256, 12, 256, 48
OS_FACTOR = Rational(4, 3)


def low_round_trip(device="cuda") -> PFBRoundTrip:
    """The SKA-Low round-trip module with its state on ``device``."""
    filt = fir.design_pfb_fir_filter(N_CHAN, OS_FACTOR, TAPS_PER_CHAN)
    return PFBRoundTrip.from_filter(filt, N_CHAN, OS_FACTOR, L, OVERLAP,
                                    device=device)


def mid_round_trip(device="cuda") -> PaddedPFBRoundTrip:
    """The SKA-Mid round-trip module with its state on ``device``; the
    filter is designed and cached under ``config/`` on first use."""
    cfg = load_config("mid")
    return PaddedPFBRoundTrip.from_filter(
        cfg.load_fir_filter_coeff(), cfg.channels, cfg.os_factor,
        cfg.input_fft_length, cfg.input_overlap, device=device,
        temporal_taper=cfg.temporal_taper,
    )


def entry(device="cuda", n_dat: int = 2**18, seed: int = 0):
    """Return (fn, example_args): fn maps (re, im) float32 input streams
    (n_pol, n_dat) to the (re, im) inverted output (n_pol, 1, n_out), on
    ``device``."""
    model = low_round_trip(device)

    def forward(xr, xi):
        x = torch.complex(
            torch.as_tensor(xr, device=device), torch.as_tensor(xi, device=device)
        )
        out = model(x)
        return out.real, out.imag

    rng = np.random.default_rng(seed)
    xr = rng.standard_normal((2, n_dat)).astype(np.float32)
    xi = rng.standard_normal((2, n_dat)).astype(np.float32)
    return forward, (xr, xi)
