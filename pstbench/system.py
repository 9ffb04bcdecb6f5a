"""The system under test: the PyTorch/CUDA port's public entries.

This is the one module of the benchmark that imports the program
(``ska_pst_dsp_tpu_torch``), and only inside its functions. Everything
else of the benchmark (traffic, reference, arithmetic) stands without it.
"""

from __future__ import annotations

import numpy as np


class PortConfig:
    """The configuration as the program's streaming stages read it."""

    def __init__(self, cfg: dict, filt: np.ndarray):
        self._filt = filt
        self.analysis_function = cfg["analysis"]
        self.channels = cfg["channels"]
        self.os_factor = cfg["os_factor"]
        self.input_fft_length = cfg["input_fft_length"]
        self.input_overlap = cfg["input_overlap"]
        self.deripple = cfg["deripple"]
        self.temporal_taper = cfg["temporal_taper"]
        self.kept_channels = None

    def load_fir_filter_coeff(self) -> np.ndarray:
        return self._filt


def round_trip(cfg: dict, filt: np.ndarray, device):
    """The one-shot round trip (``models.round_trip``): ``PFBRoundTrip``
    for the single-stage analysis, ``PaddedPFBRoundTrip`` for the padded
    one, built with ``from_filter`` on ``device``."""
    from ska_pst_dsp_tpu_torch.models.round_trip import PaddedPFBRoundTrip, PFBRoundTrip

    cls = {"polyphase_analysis": PFBRoundTrip,
           "polyphase_analysis_padded": PaddedPFBRoundTrip}[cfg["analysis"]]
    return cls.from_filter(filt, cfg["channels"], cfg["os_factor"], cfg["input_fft_length"],
                           cfg["input_overlap"], device=device,
                           temporal_taper=cfg["temporal_taper"], deripple=cfg["deripple"])


def stream(cfg: dict, filt: np.ndarray, device):
    """The streaming stages (``models.streaming``): a ``FilterBank`` and an
    ``InverseFilterBank`` on ``device``, each with its initial state."""
    from ska_pst_dsp_tpu_torch.models.streaming import FilterBank, InverseFilterBank

    pc = PortConfig(cfg, filt)
    fb, inv = FilterBank(pc, device=device), InverseFilterBank(pc, device=device)
    return fb, inv


def load_split(path: str, count: int, offset_samples: int, device):
    """``io.dada.load_split``: a window of a DADA file as complex64
    (n_pol, n_chan, count) on ``device``."""
    from ska_pst_dsp_tpu_torch.io import dada

    return dada.load_split(path, count=count, offset_samples=offset_samples, device=device)[0]
