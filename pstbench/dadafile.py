"""DADA files: a plain writer of the benchmark's inputs, and the reader the
reference uses.

The format (the SKA PST DSP model's write_header.m / read_header.m): an
ASCII header of HDR_SIZE bytes (``KEY VALUE`` lines, HDR_SIZE first, NUL
padding), then little-endian words in TFP order, re/im interleaved for
NDIM 2. The writer is a plain copy of the program's ``io.dada.save`` for
float32 complex data; the reader takes the words with NumPy alone, so the
reference never sees the program's ingest.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable

import numpy as np

HDR_SIZE = 4096


def header_bytes(header: Dict[str, str]) -> bytes:
    """The header block: HDR_SIZE first, the other keys sorted, NUL padded."""
    hdr = {k: str(v) for k, v in header.items()}
    hdr["HDR_SIZE"] = str(HDR_SIZE)
    lines = [f"HDR_SIZE {HDR_SIZE}"] + [f"{k} {v}" for k, v in sorted(hdr.items())
                                        if k != "HDR_SIZE"]
    body = ("\n".join(lines) + "\n").encode("ascii")
    if len(body) > HDR_SIZE:
        raise ValueError("header longer than HDR_SIZE")
    return body + b"\x00" * (HDR_SIZE - len(body))


def write(path: str, header: Dict[str, str], windows: Iterable[np.ndarray]) -> None:
    """Write float32 complex (n_pol, n_dat) windows one after another as
    one NCHAN 1, NBIT 32, NDIM 2 file, synced to disk."""
    with open(path, "wb") as f:
        hdr = dict(header, NBIT="32", NDIM="2", NCHAN="1")
        first = True
        for w in windows:
            if first:
                f.write(header_bytes(dict(hdr, NPOL=str(w.shape[0]))))
                first = False
            words = np.empty((w.shape[1], w.shape[0], 2), dtype=np.float32)  # (T, P, re/im)
            words[..., 0] = w.real.T
            words[..., 1] = w.imag.T
            words.tofile(f)
        # written back to disk now, so that no writeback competes with the
        # reads that follow; the pages stay in the page cache
        f.flush()
        os.fsync(f.fileno())


def read_window(path: str, n_pol: int, start: int, count: int) -> np.ndarray:
    """complex128 (n_pol, count) from an NCHAN 1, NBIT 32, NDIM 2 file,
    samples [start, start + count)."""
    words = np.fromfile(path, dtype="<f4", count=count * n_pol * 2,
                        offset=HDR_SIZE + start * n_pol * 2 * 4)
    if words.size != count * n_pol * 2:
        raise IOError(f"{path}: window [{start}, {start + count}) runs past the end")
    words = words.reshape(count, n_pol, 2).astype(np.float64)
    return (words[..., 0] + 1j * words[..., 1]).T
