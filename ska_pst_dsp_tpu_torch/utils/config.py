"""Configuration system.

The port's copy of :mod:`ska_pst_dsp_tpu.utils.config`, the equivalent of
the reference's single-JSON-source config (config/test.config.json +
matlab/default_config.m:1-36 + python/data_gen/config.py:35-71). The same
named sub-configs exist (``low``, ``mid``, ``sps``, ``lowpsi``, ``low_alt``,
``low_external``, ``mid_external``) with the same keys; FIR coefficient
files are .npy files designed on first use by
:mod:`ska_pst_dsp_tpu_torch.design.fir` and cached in the repository's
``config/`` directory, which both packages share.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np

from .rational import Rational

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))
CONFIG_DIR = os.path.abspath(os.path.join(_THIS_DIR, "..", "..", "config"))
DATA_DIR = os.path.abspath(os.path.join(_THIS_DIR, "..", "..", "data"))
TEST_CONFIG_FILE = os.path.join(CONFIG_DIR, "test.config.json")


@dataclasses.dataclass
class Config:
    """One named filterbank configuration (default_config.m struct)."""

    name: str
    analysis_function: str
    os_factor: Rational
    channels: int
    input_fft_length: int
    input_overlap: int
    fir_filter_coeff_file_path: str
    fir_filter_taps: int
    blocks: int = 3
    n_pol: int = 2
    deripple: bool = True
    temporal_taper: str = "tukey"
    header_file_path: str = "default_header.json"
    fir_offset_direction: int = 0
    kludge_offset: int = 0
    kept_channels: Optional[int] = None
    dm: Optional[float] = None
    period: Optional[float] = None
    dump_stage: Optional[str] = None
    backend: Optional[Dict[str, str]] = None
    comment: str = ""
    dtype: str = "single"
    config_dir: str = CONFIG_DIR
    data_dir: str = DATA_DIR

    # -- derived ---------------------------------------------------------
    @property
    def n_chan(self) -> int:
        return self.channels

    @property
    def fir_filter_path(self) -> str:
        return os.path.join(self.config_dir, self.fir_filter_coeff_file_path)

    @property
    def header_path(self) -> str:
        return os.path.join(self.config_dir, self.header_file_path)

    def load_fir_filter_coeff(self) -> np.ndarray:
        """Load (designing + caching on first use) this config's prototype
        FIR filter coefficients (read_fir_filter_coeff.m equivalent)."""
        from ..design import fir

        return fir.load_or_design(self)

    def load_header(self) -> Dict[str, str]:
        with open(self.header_path) as f:
            return {k: str(v) for k, v in json.load(f).items()}


def _to_config(name: str, raw: dict, config_dir: str) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    kwargs = {k: v for k, v in raw.items() if k in fields}
    kwargs["os_factor"] = Rational.coerce(raw["os_factor"])
    kwargs["name"] = name
    kwargs["config_dir"] = config_dir
    return Config(**kwargs)


def load_config(name: str = "low", config_path: str = TEST_CONFIG_FILE) -> Config:
    """Load a named sub-config from test.config.json (config.py:35-46)."""
    with open(config_path) as f:
        all_configs = json.load(f)
    if name not in all_configs:
        raise KeyError(f"no config {name!r}; available: {sorted(all_configs)}")
    return _to_config(name, all_configs[name], os.path.dirname(os.path.abspath(config_path)))


def available_configs(config_path: str = TEST_CONFIG_FILE):
    with open(config_path) as f:
        return sorted(json.load(f).keys())
