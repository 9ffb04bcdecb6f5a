"""The DADA ingest engine: a file's raw words to the card, unpacked there.

Counterpart of :mod:`ska_pst_dsp_tpu.io.native`, the JAX package's binding
of its host C++ engine (``native/dada_engine.cpp``: an mmap'd read, the
word conversion and the TFP -> PFT corner turn on a thread pool). Here the
host only reads: a window's raw bytes are read once, from the offset the
JAX engine computes, into pinned host memory (from PyTorch's caching host
allocator) by a few threads, each ``preadv`` taking one contiguous part,
and copied to the card ``non_blocking`` in one copy.
The conversion and the corner turn are the kernels of
:mod:`ska_pst_dsp_tpu_torch.ops.kernels.dada_unpack` on the card. A write
packs on the card, copies the words back and appends them.

The names and arguments are the JAX module's, with a ``device`` (default
the card; ``"cpu"`` reads into host memory and runs the kernels' plain
versions). Where the JAX functions give or take split (re, im) float32
planes, these give or take one complex64 (n_pol, n_chan, count) tensor.
On the card nothing falls back: a build or launch failure raises.
"""

from __future__ import annotations

import concurrent.futures
import functools
import logging
import os
import re

import torch

from ..ops.kernels import _build
from ..ops.kernels.dada_unpack import (
    HEAP, check_nbit, dada_pack, dada_unpack, lowcbf_unpack, pair_bytes,
)

module_logger = logging.getLogger(__name__)

#: reading threads, at most; a thread takes one contiguous part of the
#: window, of PART bytes or more
THREADS = 8
PART = 4 << 20
#: bytes of a header that header_size reads (dada_engine.cpp dada_header_size)
HEADER_SCAN = 65535

#: HDR_SIZE's value as C's strtoll reads it: leading space, a sign, digits
_HDR_VALUE = re.compile(rb"[ \t\n\v\f\r]*([+-]?[0-9]+)")


def available() -> bool:
    """Whether the engine can run on the card: a CUDA card and the kernel
    library, built from the checkout's sources (nvcc on first use)."""
    if not torch.cuda.is_available():
        return False
    try:
        _build.library()
    except (RuntimeError, OSError) as exc:
        module_logger.debug("kernel library unavailable: %s", exc)
        return False
    return True


def header_size(path: str) -> int:
    """HDR_SIZE of a DADA file, read as the JAX engine reads it: the text
    after the first ``HDR_SIZE`` in the first 64 KiB, up to the first NUL,
    parsed as C's strtoll. ValueError where there is none, or it is not
    positive."""
    with open(path, "rb") as f:
        text = f.read(HEADER_SCAN).split(b"\x00", 1)[0]
    at = text.find(b"HDR_SIZE")
    m = _HDR_VALUE.match(text, at + 8) if at >= 0 else None
    size = int(m.group(1)) if m else 0
    if size <= 0:
        raise ValueError(f"{path}: no parseable HDR_SIZE")
    return size


def _fill(fd: int, view: memoryview, a: int, b: int, offset: int) -> None:
    """view[a:b] from the file's bytes at offset + a."""
    while a < b:
        got = os.preadv(fd, [view[a:b]], offset + a)
        if got == 0:
            raise IOError(f"file ends before byte {offset + b}")
        a += got


@functools.lru_cache(maxsize=None)
def _pool() -> concurrent.futures.ThreadPoolExecutor:
    """The reading threads, started on the first read and kept: a thread
    started for each read costs more than the read of a small window."""
    return concurrent.futures.ThreadPoolExecutor(THREADS, thread_name_prefix="dada-read")


def read_into(path: str, offset: int, out: torch.Tensor) -> None:
    """Fill the 1-D uint8 CPU tensor ``out`` with the file's bytes from
    ``offset``: the window cut into up to THREADS contiguous parts of PART
    bytes or more, each read by a thread of its own (``os.preadv`` releases
    the interpreter lock). IOError where the file ends first."""
    view = memoryview(out.numpy())
    n = len(view)
    k = max(1, min(THREADS, n // PART))
    edges = [n * i // k for i in range(k + 1)]
    fd = os.open(path, os.O_RDONLY)
    try:
        if k == 1:
            _fill(fd, view, 0, n, offset)
        else:
            list(_pool().map(lambda i: _fill(fd, view, edges[i], edges[i + 1], offset),
                             range(k)))
    finally:
        os.close(fd)


def read_bytes(path: str, offset: int, nbytes: int, device=None) -> torch.Tensor:
    """The file's bytes [offset, offset + nbytes) as a 1-D uint8 tensor on
    ``device`` (default the card): on the card read into pinned host memory,
    then one copy queued on the current stream. IOError where the file is
    shorter."""
    dev = torch.device("cuda" if device is None else device)
    if offset + nbytes > os.path.getsize(path):
        raise IOError(f"{path}: window of {nbytes} bytes at {offset} runs past the end "
                      f"({os.path.getsize(path)} bytes)")
    if dev.type == "cpu":
        out = torch.empty(nbytes, dtype=torch.uint8)
        read_into(path, offset, out)
        return out
    if dev.type != "cuda":
        raise ValueError(f"the engine reads to cuda or cpu, not {dev}")
    # PyTorch's caching host allocator reuses pinned blocks, and hands one
    # out again only after the copies queued from it have finished
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    read_into(path, offset, host)
    return host.to(dev, non_blocking=True)


def read_split(path: str, hdr_size: int, n_pol: int, n_chan: int, nbit: int,
               start: int, count: int, device=None) -> torch.Tensor:
    """Read ``count`` time samples from sample ``start`` as one complex64
    (n_pol, n_chan, count) tensor on ``device`` (the JAX engine gives split
    re / im float32 planes). NBIT 8 / 16 (int) or 32 / 64 (float; float64
    rounds to nearest). IOError for a window past the end; ValueError for
    another NBIT."""
    check_nbit("dada_unpack", nbit)
    pair = pair_bytes(nbit)
    raw = read_bytes(path, hdr_size + start * n_pol * n_chan * pair,
                     count * n_pol * n_chan * pair, device)
    return dada_unpack(raw, nbit, n_pol, n_chan, count)


def append_split(path: str, data: torch.Tensor, nbit: int = 32, scale: float = 1.0) -> None:
    """Append complex64 (n_pol, n_chan, count) samples as TFP records (the
    header must already exist in the file), byte for byte as the JAX
    engine's dada_write_split (which takes split re / im planes): each
    component times ``scale``, and for NBIT 8 / 16 rounded half to even and
    clipped. The words are packed where ``data`` lies and copied back.
    ValueError for an NBIT but 8, 16 and 32."""
    check_nbit("dada_pack", nbit)
    words = dada_pack(data, nbit, scale).cpu()
    with open(path, "ab") as f:
        f.write(memoryview(words.numpy()))


def read_lowcbf_split(path: str, hdr_size: int, n_pol: int, n_chan: int, nbit: int,
                      start_heap: int, n_heaps: int, device=None) -> torch.Tensor:
    """Read ``n_heaps`` 32-sample LowCBF heaps from heap ``start_heap`` as
    one complex64 (n_pol, n_chan, 32 * n_heaps) tensor on ``device``. NBIT
    8, 16 or 32; IOError for a window past the end, ValueError for another
    NBIT."""
    check_nbit("lowcbf_unpack", nbit)
    heap = HEAP * n_pol * n_chan * pair_bytes(nbit)
    raw = read_bytes(path, hdr_size + start_heap * heap, n_heaps * heap, device)
    return lowcbf_unpack(raw, nbit, n_pol, n_chan, n_heaps)
