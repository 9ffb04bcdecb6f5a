"""DADA file format codec: :func:`save`, :func:`append`, :func:`load`, the
FIR coefficients a header carries, and the :class:`DADAFile` object API;
:func:`load_split` reads through the ingest engine (:mod:`.native`) to the
card.

The port's copy of :mod:`ska_pst_dsp_tpu.io.dada`; a file written by either
package is read by the other, and both write the same bytes for the same
array and header.

Format recap:
  * ASCII header of HDR_SIZE bytes (default 4096): ``KEY VALUE`` lines,
    ``#`` comments, NUL padding; HDR_SIZE may announce a larger header, in
    which case the reader re-reads with the announced size.
  * Data: little-endian stream in TFP order (time slowest, then channel,
    then polarization), re/im interleaved when NDIM=2, dtype from NBIT.

Arrays follow the reference kernel convention (P, F, T) complex;
``DADAFile.data`` exposes (T, F, P) for psr_formats API parity. LowCBF
heap files (INSTRUMENT=LowCBF: 32-sample heaps, :mod:`.lowcbf`) are read
through the heap reshape, in windows of whole heaps; :func:`save_lowcbf`
writes one.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.dada_unpack import check_nbit
from ..utils.rational import Rational
from .lowcbf import NSAMP_PER_HEAP, flatten_low_cbf_stream, reshape_low_cbf_data

DEFAULT_HDR_SIZE = 4096

_NBIT_TO_DTYPE = {
    8: np.int8,
    16: np.int16,
    32: np.float32,
    64: np.float64,
}
_DTYPE_TO_NBIT = {
    np.dtype(np.int8): 8,
    np.dtype(np.uint8): 8,
    np.dtype(np.int16): 16,
    np.dtype(np.uint16): 16,
    np.dtype(np.float32): 32,
    np.dtype(np.complex64): 32,
    np.dtype(np.float64): 64,
    np.dtype(np.complex128): 64,
}


def parse_header(raw: bytes) -> Dict[str, str]:
    """Parse ASCII key-value header text into a dict (read_header.m:13-40)."""
    header: Dict[str, str] = {}
    text = raw.split(b"\x00", 1)[0].decode("ascii", errors="replace")
    for line in text.split("\n"):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) > 1:
            header[parts[0]] = parts[1]
    return header


def read_header(path: str) -> Dict[str, str]:
    """Read a DADA header, honoring a self-announced HDR_SIZE: retry with the
    announced (or doubled) size like the reference reader (read_header.m:29-38)."""
    size = DEFAULT_HDR_SIZE
    file_size = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            f.seek(0)
            header = parse_header(f.read(size))
            announced = int(header.get("HDR_SIZE", 0)) if "HDR_SIZE" in header else None
            if announced is None:
                size *= 2
                if size > max(file_size, DEFAULT_HDR_SIZE) * 2:
                    raise ValueError(
                        f"{path} has no parseable DADA header (no HDR_SIZE key)"
                    )
                continue
            if announced != size:
                size = announced
                continue
            return header


def serialize_header(header: Dict[str, str]) -> bytes:
    """Serialize a header dict: HDR_SIZE line first, NUL padding to HDR_SIZE,
    doubling HDR_SIZE on overflow (write_header.m:8-47)."""
    hdr = {k: str(v) for k, v in header.items()}
    hdr.setdefault("HDR_SIZE", str(DEFAULT_HDR_SIZE))
    while True:
        size = int(hdr["HDR_SIZE"])
        lines = [f"HDR_SIZE {hdr['HDR_SIZE']}"]
        lines += [f"{k} {v}" for k, v in sorted(hdr.items()) if k != "HDR_SIZE"]
        body = ("\n".join(lines) + "\n").encode("ascii")
        if len(body) <= size:
            return body + b"\x00" * (size - len(body))
        hdr["HDR_SIZE"] = str(size * 2)


def _data_dtype(header: Dict[str, str]) -> np.dtype:
    nbit = int(header.get("NBIT", 32))
    try:
        return np.dtype(_NBIT_TO_DTYPE[nbit])
    except KeyError:
        raise ValueError(f"unsupported NBIT={nbit}") from None


def load_split(path: str, count: Optional[int] = None, offset_samples: int = 0,
               device=None) -> Tuple[torch.Tensor, Dict[str, str]]:
    """Load a DADA file through the ingest engine (:mod:`.native`: the raw
    words read to ``device``, default the card, and unpacked there) as one
    complex64 (n_pol, n_chan, n_dat) tensor, plus the header; the JAX
    package's ``load_split`` gives split (re, im) float32 planes. Requires
    NDIM=2; a LowCBF window must be whole 32-sample heaps; ``count``
    defaults to the samples after ``offset_samples``. See :func:`load` for
    the generic numpy path."""
    from . import native

    header = read_header(path)
    if int(header.get("NDIM", 2)) != 2:
        raise ValueError("load_split requires complex (NDIM=2) data")
    n_pol = int(header.get("NPOL", 1))
    n_chan = int(header.get("NCHAN", 1))
    nbit = int(header.get("NBIT", 32))
    hdr_size = int(header["HDR_SIZE"])
    lowcbf = header.get("INSTRUMENT") == "LowCBF"
    check_nbit("lowcbf_unpack" if lowcbf else "dada_unpack", nbit)
    if count is None:
        bytes_per_samp = n_pol * n_chan * 2 * (nbit // 8)
        count = (os.path.getsize(path) - hdr_size) // bytes_per_samp - offset_samples
    if lowcbf:
        if offset_samples % NSAMP_PER_HEAP or count % NSAMP_PER_HEAP:
            raise ValueError("LowCBF windows must be whole 32-sample heaps")
        data = native.read_lowcbf_split(path, hdr_size, n_pol, n_chan, nbit,
                                        offset_samples // NSAMP_PER_HEAP,
                                        count // NSAMP_PER_HEAP, device)
    else:
        data = native.read_split(path, hdr_size, n_pol, n_chan, nbit, offset_samples, count,
                                 device)
    return data, header


def load(path: str, count: Optional[int] = None, offset_samples: int = 0
         ) -> Tuple[np.ndarray, Dict[str, str]]:
    """Load a DADA file → ((n_pol, n_chan, n_dat) array, header).

    Complex data (NDIM=2) come back as complex64/complex128; real as the
    stored dtype. ``count``/``offset_samples`` select a time-sample window
    for streaming reads (DADARead.generate equivalent); in a LowCBF heap
    file both must be whole 32-sample heaps.
    """
    header = read_header(path)
    lowcbf = header.get("INSTRUMENT") == "LowCBF"
    if lowcbf and (offset_samples % NSAMP_PER_HEAP or (count or 0) % NSAMP_PER_HEAP):
        raise ValueError("LowCBF windows must be whole 32-sample heaps")
    hdr_size = int(header["HDR_SIZE"])
    n_dim = int(header.get("NDIM", 2))
    n_pol = int(header.get("NPOL", 1))
    n_chan = int(header.get("NCHAN", 1))
    dtype = _data_dtype(header)

    words_per_sample = n_dim * n_pol * n_chan
    offset_bytes = hdr_size + offset_samples * words_per_sample * dtype.itemsize
    n_words = -1 if count is None else count * words_per_sample
    raw = np.fromfile(path, dtype=dtype, count=n_words, offset=offset_bytes)
    raw = raw[: (raw.size // words_per_sample) * words_per_sample]

    if n_dim == 2:
        raw = raw.astype(np.float32 if dtype.itemsize <= 4 else np.float64)
        data = raw[0::2] + 1j * raw[1::2]
    else:
        data = raw
    # TFP stream → (T, F, P) → transpose to (P, F, T)
    data = data.reshape(-1, n_chan, n_pol).transpose(2, 1, 0)
    if lowcbf:
        data = reshape_low_cbf_data(data, header)
    return data, header


def _quantize(data: np.ndarray, nbit: int) -> np.ndarray:
    """Round complex data to int8/int16 components (sgcht.m:555-566 nbit
    output quantization)."""
    target = np.int8 if nbit == 8 else np.int16
    info = np.iinfo(target)
    re = np.clip(np.round(data.real), info.min, info.max).astype(target)
    im = np.clip(np.round(data.imag), info.min, info.max).astype(target)
    out = np.empty(data.shape + (2,), dtype=target)
    out[..., 0] = re
    out[..., 1] = im
    return out


def save(path: str, data: np.ndarray, header: Dict[str, str],
         nbit: Optional[int] = None) -> None:
    """Write a (n_pol, n_chan, n_dat) array + header as a DADA file,
    updating NBIT/NDIM/NPOL/NCHAN from the array (write_dada_header.m:20-36).
    ``nbit`` of 8/16 quantizes complex data to integer components."""
    if data.ndim != 3:
        raise ValueError(f"expected (n_pol, n_chan, n_dat) array, got {data.shape}")
    if nbit in (8, 16) and np.iscomplexobj(data):
        q = _quantize(data, nbit)
        hdr = {k: str(v) for k, v in header.items()}
        hdr.update(
            NBIT=str(nbit), NDIM="2", NPOL=str(data.shape[0]),
            NCHAN=str(data.shape[1]),
        )
        tfp = q.transpose(2, 1, 0, 3)  # (T, F, P, 2)
        with open(path, "wb") as f:
            f.write(serialize_header(hdr))
            np.ascontiguousarray(tfp).tofile(f)
        return
    hdr = {k: str(v) for k, v in header.items()}
    is_complex = np.iscomplexobj(data)
    base = np.dtype(data.real.dtype) if is_complex else np.dtype(data.dtype)
    hdr["NBIT"] = str(_DTYPE_TO_NBIT[base])
    hdr["NDIM"] = "2" if is_complex else "1"
    hdr["NPOL"] = str(data.shape[0])
    hdr["NCHAN"] = str(data.shape[1])

    tfp = data.transpose(2, 1, 0)  # (T, F, P)
    if is_complex:
        flat = np.empty(tfp.size * 2, dtype=base)
        flat[0::2] = tfp.real.ravel()
        flat[1::2] = tfp.imag.ravel()
    else:
        flat = np.ascontiguousarray(tfp).ravel()

    with open(path, "wb") as f:
        f.write(serialize_header(hdr))
        flat.tofile(f)


def save_lowcbf(path: str, data: np.ndarray, header: Dict[str, str]) -> None:
    """Write a (n_pol, n_chan, n_dat) complex array as a LowCBF heap file
    (INSTRUMENT=LowCBF): the stream of whole 32-sample heaps of
    :func:`.lowcbf.flatten_low_cbf_stream` (a trailing partial heap is
    dropped), re/im interleaved in the array's real dtype; :func:`load`
    reads it back."""
    if data.ndim != 3 or not np.iscomplexobj(data):
        raise ValueError(f"expected a complex (n_pol, n_chan, n_dat) array, got {data.shape}")
    flat = flatten_low_cbf_stream(data)
    base = np.dtype(data.real.dtype)
    hdr = {k: str(v) for k, v in header.items()}
    hdr.update(INSTRUMENT="LowCBF", NBIT=str(_DTYPE_TO_NBIT[base]), NDIM="2",
               NPOL=str(data.shape[0]), NCHAN=str(data.shape[1]))
    words = np.empty(flat.size * 2, dtype=base)
    words[0::2] = flat.real
    words[1::2] = flat.imag
    with open(path, "wb") as f:
        f.write(serialize_header(hdr))
        words.tofile(f)


def append(path: str, data: np.ndarray) -> None:
    """Append more (n_pol, n_chan, n_dat) samples to an existing DADA file
    (streaming DADAWrite.write equivalent)."""
    header = read_header(path)
    is_complex = np.iscomplexobj(data)
    if (header.get("NDIM") == "2") != is_complex:
        raise ValueError("complexity mismatch on append")
    nbit = int(header["NBIT"])
    if is_complex and nbit in (8, 16):
        q = _quantize(data, nbit)
        tfp = q.transpose(2, 1, 0, 3)
        with open(path, "ab") as f:
            np.ascontiguousarray(tfp).tofile(f)
        return
    base = np.dtype(data.real.dtype) if is_complex else np.dtype(data.dtype)
    if _DTYPE_TO_NBIT[base] != nbit:
        raise ValueError("dtype mismatch on append")
    tfp = data.transpose(2, 1, 0)
    if is_complex:
        flat = np.empty(tfp.size * 2, dtype=base)
        flat[0::2] = tfp.real.ravel()
        flat[1::2] = tfp.imag.ravel()
    else:
        flat = np.ascontiguousarray(tfp).ravel()
    with open(path, "ab") as f:
        flat.tofile(f)


# ---------------------------------------------------------------------------
# FIR filter coefficients embedded in headers (add_fir_filter_to_header.m)
# ---------------------------------------------------------------------------

def add_fir_filter_to_header(header: Dict[str, str], fir_coeffs, os_factors) -> Dict[str, str]:
    """Record per-stage FIR coefficients so inversion is self-describing from
    the data file (add_fir_filter_to_header.m:26-39): COEFF_<i> as
    comma-separated %0.6E, OVERSAMP_<i>, NTAP_<i>, NSTAGE."""
    if not isinstance(fir_coeffs, (list, tuple)):
        fir_coeffs = [fir_coeffs]
    if not isinstance(os_factors, (list, tuple)):
        os_factors = [os_factors]
    header = dict(header)
    header["NSTAGE"] = str(len(fir_coeffs))
    for i, (coeff, osf) in enumerate(zip(fir_coeffs, os_factors)):
        osf = Rational.coerce(osf)
        coeff = np.asarray(coeff, dtype=np.float64).ravel()
        header[f"COEFF_{i}"] = ",".join(f"{c:0.6E}" for c in coeff)
        header[f"OVERSAMP_{i}"] = str(osf)
        header[f"NTAP_{i}"] = str(coeff.size)
    return header


def get_fir_filters_from_header(header: Dict[str, str]):
    """Inverse of :func:`add_fir_filter_to_header`: list of (coeffs, os_factor)."""
    n_stage = int(header.get("NSTAGE", 0))
    out = []
    for i in range(n_stage):
        coeff = np.array(
            [float(x) for x in header[f"COEFF_{i}"].split(",")], dtype=np.float64
        )
        osf = Rational.from_str(header[f"OVERSAMP_{i}"])
        out.append((coeff, osf))
    return out


# ---------------------------------------------------------------------------
# psr_formats-style object API
# ---------------------------------------------------------------------------

class DADAFile:
    """Object wrapper with the ``psr_formats.DADAFile`` surface the reference
    Python harness expects: ``.data`` is (n_dat, n_chan, n_pol) and loading /
    dumping is explicit."""

    def __init__(self, file_path: str):
        self.file_path = file_path
        self._data: Optional[np.ndarray] = None  # stored (P, F, T)
        self.header: Dict[str, str] = {}

    # -- psr_formats API -------------------------------------------------
    @property
    def data(self) -> Optional[np.ndarray]:
        if self._data is None:
            return None
        return self._data.transpose(2, 1, 0)

    @data.setter
    def data(self, value: np.ndarray):
        value = np.asarray(value)
        if value.ndim != 3:
            raise ValueError("DADAFile.data must be (n_dat, n_chan, n_pol)")
        self._data = value.transpose(2, 1, 0)

    @property
    def ndat(self) -> int:
        return 0 if self._data is None else self._data.shape[2]

    @property
    def nchan(self) -> int:
        return 0 if self._data is None else self._data.shape[1]

    @property
    def npol(self) -> int:
        return 0 if self._data is None else self._data.shape[0]

    def load_data(self) -> "DADAFile":
        self._data, self.header = load(self.file_path)
        return self

    def dump_data(self) -> str:
        if self._data is None:
            raise RuntimeError("no data to dump")
        os.makedirs(os.path.dirname(os.path.abspath(self.file_path)), exist_ok=True)
        save(self.file_path, self._data, self.header)
        return self.file_path

    # -- native (P, F, T) access ----------------------------------------
    @property
    def data_pft(self) -> Optional[np.ndarray]:
        return self._data

    @data_pft.setter
    def data_pft(self, value: np.ndarray):
        self._data = np.asarray(value)

    def __getitem__(self, key: str) -> str:
        return self.header[key]

    def __setitem__(self, key: str, value) -> None:
        self.header[key] = str(value)

    def __contains__(self, key: str) -> bool:
        return key in self.header
