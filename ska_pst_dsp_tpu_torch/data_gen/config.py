"""data_gen configuration shim.

The port's copy of :mod:`ska_pst_dsp_tpu.data_gen.config`, on the
port's :mod:`..utils.config`; the equivalent of python/data_gen/config.py:35-71: a module-level default
sub-config plus the config/products directory anchors. The default
sub-config name comes from SKA_PST_CONFIG (default "low")."""

from __future__ import annotations

import os

from ..utils import config as _config

__all__ = ["load_config", "config", "config_dir", "products_dir"]

config_dir = _config.CONFIG_DIR
products_dir = os.path.abspath(
    os.path.join(_config.CONFIG_DIR, "..", "products")
)


def load_config(name: str = None):
    name = name or os.environ.get("SKA_PST_CONFIG", "low")
    return _config.load_config(name)


config = load_config()
