"""Test-vector generation.

The port's copy of :mod:`ska_pst_dsp_tpu.data_gen.generate_test_vector`,
the equivalent of python/data_gen/generate_test_vector.py:24-209:
generators writing DADA files with the reference's deterministic output
naming ``{func}.{nbins}.{args}.{npol}.{dtype}.{backend}``.

The samples are made on the host in numpy (the noise from
``np.random.default_rng(seed)``), so a file is the same, byte for byte,
whichever package writes it; ``backend`` (default ``torch``) names the
backend in the file name only.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional

import numpy as np

from . import util
from .config import config, config_dir
from ..io import dada

__all__ = ["complex_sinusoid", "time_domain_impulse", "noise", "generate_test_vector"]

module_logger = logging.getLogger(__name__)


def complex_sinusoid(
    n: int,
    freqs: List[float],
    phases: List[float],
    bin_offset: float = 0.0,
    dtype: np.dtype = np.complex64,
) -> np.ndarray:
    """Sum of tones: exp(1j*(2*pi*(freq + bin_offset)/n*t + phase)); a
    fractional freq < 1.0 is interpreted as a bin index fraction
    (generate_test_vector.py:24-48)."""
    if not hasattr(freqs, "__iter__"):
        freqs = [freqs]
        phases = [phases]
    t = np.arange(n)
    sig = np.zeros(n, dtype=np.complex128)
    for freq, phase in zip(freqs, phases):
        if abs(freq) < 1.0:
            freq = int(n * freq)
        sig += np.exp(1j * (2 * np.pi * (freq + bin_offset) / n * t + phase))
    return sig.astype(dtype)


def time_domain_impulse(
    n: int,
    offsets: List[float],
    widths: List[int],
    dtype: np.dtype = np.complex64,
) -> np.ndarray:
    """Unit rectangles at given offsets (fractions of n when < 1.0)
    (generate_test_vector.py:51-71)."""
    if not hasattr(offsets, "__iter__"):
        offsets = [offsets]
        widths = [widths]
    sig = np.zeros(n, dtype=dtype)
    for offset, width in zip(offsets, widths):
        if 0 < offset < 1.0:
            offset = int(offset * n)
        offset = int(offset)
        sig[offset: offset + int(width)] = 1.0
    return sig


def noise(n: int, scale: float = 1.0, seed: int = 0,
          dtype: np.dtype = np.complex64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (
        scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ).astype(dtype)


_FUNC_LOOKUP = {
    "time": time_domain_impulse,
    "freq": complex_sinusoid,
    "noise": lambda n, *a, dtype=np.complex64, **k: noise(n, dtype=dtype),
}


@util.partialize
def generate_test_vector(
    *args,
    n_bins: int,
    domain_name: str,
    header_template: Optional[str] = None,
    output_file_name: Optional[str] = None,
    output_dir: str = "./",
    n_pol: int = 1,
    dtype: np.dtype = np.complex64,
    backend: str = "torch",
) -> dada.DADAFile:
    """Generate a DADA test vector.

    Usage (mirrors the reference factory style)::

        generator = generate_test_vector(backend="torch", domain_name="freq")
        dada_file = generator([10], [np.pi/4], 0.1, n_bins=1000, n_pol=2,
                              output_dir="/tmp")
    """
    if header_template is None:
        header_template = os.path.join(config_dir, config.header_file_path)

    if args:
        args_list = []
        for arg in args:
            if hasattr(arg, "__iter__"):
                arg = arg[0]
            args_list.append(f"{arg:.3f}")
        args_str = "-".join(args_list)
    else:
        args_str = ""

    func = _FUNC_LOOKUP[domain_name]
    func_name = getattr(func, "__name__", domain_name)
    if func_name == "<lambda>":
        func_name = "noise"
    dtype_str = util.matlab_dtype_lookup[np.dtype(dtype)]
    output_base = f"{func_name}.{n_bins}.{args_str}.{n_pol}.{dtype_str}.{backend}"
    output_base, log_file_name, output_file_name = util.create_output_file_names(
        output_file_name, output_base
    )

    sig = func(n_bins, *args, dtype=dtype)

    # (T, F, P): replicate the signal across polarizations like the
    # reference (generate_test_vector.py:189-192)
    output_data = np.zeros((sig.shape[0], 1, n_pol), dtype=dtype)
    for i_pol in range(n_pol):
        output_data[:, 0, i_pol] = sig

    os.makedirs(output_dir, exist_ok=True)
    out = dada.DADAFile(os.path.join(output_dir, output_file_name))
    out.data = output_data
    with open(header_template) as f:
        out.header = {k: str(v) for k, v in json.load(f).items()}
    out.dump_data()
    module_logger.debug(
        "generate_test_vector: wrote %s (%d bins, %d pol)",
        out.file_path, n_bins, n_pol,
    )
    return out
