"""Firmware-testbench data conversion.

The port's copy of :mod:`ska_pst_dsp_tpu.io.testbench`, the equivalent
of the reference's fb_tb_to_dada.m + load_fb_tb_data.m: convert
VHDL-testbench hex dumps of filterbank output (one hex word per line,
re/im packed 16+16 bit) into DADA files so firmware output can be run
through the inversion and verification chain.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from . import dada

module_logger = logging.getLogger(__name__)


def load_fb_tb_data(path: str, n_chan: int, n_pol: int = 2,
                    word_bits: int = 32) -> np.ndarray:
    """Parse a testbench hex dump: one packed complex word per line
    (imaginary in the high half-word, real in the low), samples cycling
    pol-fastest then channel. Returns (n_pol, n_chan, n_dat) complex64."""
    words = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "//", "--")):
                continue
            words.append(int(line, 16))
    w = np.asarray(words, dtype=np.uint64)
    half = word_bits // 2
    mask = (1 << half) - 1
    re = (w & mask).astype(np.int64)
    im = ((w >> half) & mask).astype(np.int64)
    # sign-extend half-words
    sign = 1 << (half - 1)
    re = (re ^ sign) - sign
    im = (im ^ sign) - sign
    flat = (re + 1j * im).astype(np.complex64)
    n = (flat.size // (n_chan * n_pol)) * n_chan * n_pol
    flat = flat[:n]
    # stream order: pol fastest, then channel, then time (FPT per sample)
    arr = flat.reshape(-1, n_chan, n_pol)  # (T, F, P)
    return arr.transpose(2, 1, 0)


def fb_tb_to_dada(hex_path: str, out_path: str, *, n_chan: int,
                  n_pol: int = 2, header: Optional[Dict[str, str]] = None,
                  tsamp: float = 1.0, os_factor: str = "4/3") -> str:
    """Convert a testbench hex dump to a DADA file (fb_tb_to_dada.m)."""
    data = load_fb_tb_data(hex_path, n_chan, n_pol)
    hdr = dict(header or {})
    hdr.setdefault("TSAMP", str(tsamp))
    hdr.setdefault("OS_FACTOR", os_factor)
    hdr.setdefault("PFB_NCHAN", str(n_chan))
    hdr.setdefault("UTC_START", "2026-01-01-00:00:00")
    hdr.setdefault("OBS_OFFSET", "0")
    dada.save(out_path, data, hdr)
    module_logger.info("fb_tb_to_dada: %s -> %s %s", hex_path, out_path,
                       data.shape)
    return out_path
