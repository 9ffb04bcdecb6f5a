"""The round trip's constant state, under the JAX package's names.

The JAX package builds these constants inside each call; the port builds
them once, as numpy arrays, and the modules of :mod:`..models.round_trip`
hold them as buffers. Each array equals what the JAX helper of the same
name gives (tests/test_torch_slice.py and tests/test_torch_mid.py hold them
bit for bit).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from .ops.analysis import _prep_filter, padded_chan_const, ramp_table
from .ops.synthesis import synthesis_constants


def inversion_state(
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
    """Constants of the Golden inversion after an analysis with ``filt``:

    * ``t_taper`` (L,) float32 — ``windows.build(temporal_taper, ...)``;
    * ``dr`` (FN_width,) float32 — ``deripple_response`` (ones when
      ``deripple`` is False);
    * ``perm`` (n_chan,) int32 — the combine channel permutation;
    * ``elem`` (n_chan*FN_width,) complex64 or None — spectral taper x
      spectral filter, pre-rolled for the fused epilogue.
    """
    return synthesis_constants(
        n_chan, L, Rational.coerce(os_factor), input_overlap,
        deripple_coeff=np.asarray(filt) if deripple else None,
        temporal_taper=temporal_taper, spectral_taper=spectral_taper,
        combine=combine, spectral_filter=spectral_filter,
    )


def round_trip_state(filt, n_chan: int, os_factor: Union[Rational, str], L: int,
                     input_overlap: int, **inversion_kwargs
                     ) -> Dict[str, Optional[np.ndarray]]:
    """Constants of the analysis -> inversion round trip: those of
    :func:`inversion_state` (keyword arguments go to it) and

    * ``f2d`` (phases, n_chan) float32 — ``_prep_filter(filt, n_chan)``;
    * ``ramp`` (period, n_chan) complex64 — ``_phase_ramp(n_chan, step,
      period, 0)`` as re + 1j*im, period = n_chan/gcd(step, n_chan) (= nu).
    """
    step = geometry.analysis_step(n_chan, Rational.coerce(os_factor))
    return {
        "f2d": _prep_filter(filt, n_chan),
        "ramp": ramp_table(n_chan, step),
        **inversion_state(filt, n_chan, os_factor, L, input_overlap, **inversion_kwargs),
    }


def padded_round_trip_state(filt, n_chan: int, os_factor: Union[Rational, str],
                            L: int, input_overlap: int, **inversion_kwargs
                            ) -> Dict[str, Union[int, np.ndarray, None]]:
    """Constants of the zero-padded (SKA-Mid) analysis -> inversion round
    trip: those of :func:`inversion_state` (keyword arguments go to it) and

    * ``f2d_rev`` (phases, n_chan) float32 — ``_prep_filter(filt, n_chan,
      reverse=True)``;
    * ``chan_const`` (nu, n_chan) complex64 — the channel-DFT constant of
      ``_padded_fused_core`` (analysis_padded_fused.py:307-312): the ramp
      times ``n_chan * exp(-2j*pi*q/n_chan)``;
    * ``delay`` int — ``geometry.padded_sample_delay_shift``, in spectra.
    """
    os_factor = Rational.coerce(os_factor)
    return {
        "f2d_rev": _prep_filter(filt, n_chan, reverse=True),
        "chan_const": padded_chan_const(n_chan, geometry.analysis_step(n_chan, os_factor)),
        "delay": geometry.padded_sample_delay_shift(np.asarray(filt).size, n_chan,
                                                    os_factor),
        **inversion_state(filt, n_chan, os_factor, L, input_overlap, **inversion_kwargs),
    }
