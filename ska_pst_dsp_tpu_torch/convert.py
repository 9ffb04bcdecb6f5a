"""The round trip's constant state, under the JAX package's names.

The JAX package builds these constants inside each call; the port builds
them once, as numpy arrays, and :class:`..models.round_trip.PFBRoundTrip`
holds them as buffers. Each array equals what the JAX helper of the same
name gives (tests/test_torch_slice.py holds them bit for bit).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from ska_pst_dsp_tpu.utils import geometry
from ska_pst_dsp_tpu.utils.rational import Rational

from .ops.analysis import _prep_filter, ramp_table
from .ops.synthesis import synthesis_constants


def round_trip_state(
    filt,
    n_chan: int,
    os_factor: Union[Rational, str],
    L: int,
    input_overlap: int,
    temporal_taper: Union[str, np.ndarray, None] = "tukey",
    deripple: bool = True,
    spectral_taper: Union[str, np.ndarray, None] = None,
    spectral_filter=None,
    combine: int = 1,
) -> Dict[str, Optional[np.ndarray]]:
    """Constants of the analysis -> inversion round trip:

    * ``f2d`` (phases, n_chan) float32 — ``_prep_filter(filt, n_chan)``;
    * ``ramp`` (period, n_chan) complex64 — ``_phase_ramp(n_chan, step,
      period, 0)`` as re + 1j*im, period = n_chan/gcd(step, n_chan) (= nu);
    * ``t_taper`` (L,) float32 — ``windows.build(temporal_taper, ...)``;
    * ``dr`` (FN_width,) float32 — ``deripple_response`` (ones when
      ``deripple`` is False);
    * ``perm`` (n_chan,) int32 — the combine channel permutation;
    * ``elem`` (n_chan*FN_width,) complex64 or None — spectral taper x
      spectral filter, pre-rolled for the fused epilogue.
    """
    os_factor = Rational.coerce(os_factor)
    step = geometry.analysis_step(n_chan, os_factor)
    state = {
        "f2d": _prep_filter(filt, n_chan),
        "ramp": ramp_table(n_chan, step),
    }
    state.update(synthesis_constants(
        n_chan, L, os_factor, input_overlap,
        deripple_coeff=np.asarray(filt) if deripple else None,
        temporal_taper=temporal_taper, spectral_taper=spectral_taper,
        combine=combine, spectral_filter=spectral_filter,
    ))
    return state
