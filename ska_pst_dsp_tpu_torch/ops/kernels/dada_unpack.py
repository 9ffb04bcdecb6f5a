"""The DADA ingest engine's three kernels: file words -> complex64 planes
(:func:`dada_unpack`, :func:`lowcbf_unpack`) and back (:func:`dada_pack`).

Counterpart of the JAX package's host C++ engine
(``native/dada_engine.cpp``: ``convert_tfp_to_pft``,
``lowcbf_read_split``, ``convert_pft_to_tfp``), which it bound through
``ska_pst_dsp_tpu.io.native``; :mod:`ska_pst_dsp_tpu_torch.io.native` reads
a file's raw bytes to the card and runs these there. The CUDA kernels
(``csrc/dada_unpack.cu``) are a tiled transpose through shared memory
(:func:`tile_columns`) for the TFP files and one thread a word pair for the
LowCBF heaps, whose packets need no transpose.

Words are int8, int16 (NBIT 8, 16), float32 or float64 (32, 64), re and im
interleaved; a file sample holds ``n_pol * n_chan`` pairs, channel slower
than polarization. The planes are complex64 (n_pol, n_chan, count). Beside
each kernel is its plain version (``*_core``), which a CPU tensor runs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import kernel, launch, require

#: word type of each NBIT
WORDS: Dict[int, torch.dtype] = {8: torch.int8, 16: torch.int16, 32: torch.float32,
                                 64: torch.float64}
#: the NBITs each kernel takes (native/dada_engine.cpp: the read takes all
#: four, the LowCBF read and the write no float64)
NBITS: Dict[str, Tuple[int, ...]] = {"dada_unpack": (8, 16, 32, 64),
                                     "lowcbf_unpack": (8, 16, 32), "dada_pack": (8, 16, 32)}
#: the clip of the integer writes (std::nearbyint then min / max)
CLIP = {8: (-128.0, 127.0), 16: (-32768.0, 32767.0)}
#: complex samples per shared-memory tile of the TFP kernels, and samples a
#: LowCBF heap packet holds
TILE, HEAP = 1024, 32
#: thread blocks of the LowCBF kernel's grid-stride loop, at most
LOWCBF_BLOCKS = 1 << 16


def takes(kernel: str, nbit: int) -> bool:
    """Whether the card has ``kernel`` ("dada_unpack", "lowcbf_unpack",
    "dada_pack") for words of ``nbit`` bits."""
    return nbit in NBITS[kernel]


def check_nbit(kernel: str, nbit: int) -> None:
    """ValueError unless :func:`takes`."""
    if not takes(kernel, nbit):
        raise ValueError(f"{kernel} takes NBIT {NBITS[kernel]}, got NBIT={nbit}")


def pair_bytes(nbit: int) -> int:
    """Bytes of one (re, im) word pair."""
    return nbit // 4


def tile_columns(w: int) -> int:
    """log2 of the columns (channel x polarization pairs) in a tile of the
    TFP kernels: min(32, the next power of two >= w); a tile holds
    TILE >> log2 samples of each."""
    return min(5, max(0, (w - 1).bit_length()))


def _raw(raw: torch.Tensor, nbit: int, n_pairs: int, name: str) -> torch.Tensor:
    """Check a raw byte operand: contiguous uint8 of n_pairs word pairs."""
    if raw.dtype != torch.uint8 or raw.ndim != 1 or not raw.is_contiguous():
        raise TypeError(f"{name} must be a contiguous 1-D uint8 tensor, got {raw.dtype} "
                        f"{tuple(raw.shape)}")
    if raw.numel() != n_pairs * pair_bytes(nbit):
        raise ValueError(f"{name} holds {raw.numel()} bytes, expected "
                         f"{n_pairs} pairs of {pair_bytes(nbit)}")
    return raw


def _aligned(t: torch.Tensor, name: str, nbit: int) -> None:
    if t.data_ptr() % pair_bytes(nbit):
        raise ValueError(f"{name}: raw bytes at {t.data_ptr():#x} are not aligned to a "
                         f"{pair_bytes(nbit)}-byte word pair")


# --- plain versions -----------------------------------------------------------

def dada_unpack_core(raw: torch.Tensor, nbit: int, n_pol: int, n_chan: int,
                     count: int) -> torch.Tensor:
    """Plain version of :func:`dada_unpack`."""
    words = raw.view(WORDS[nbit]).reshape(count, n_chan, n_pol, 2).to(torch.float32)
    return torch.complex(words[..., 0], words[..., 1]).permute(2, 1, 0).contiguous()


def lowcbf_unpack_core(raw: torch.Tensor, nbit: int, n_pol: int, n_chan: int,
                       n_heaps: int) -> torch.Tensor:
    """Plain version of :func:`lowcbf_unpack`."""
    words = raw.view(WORDS[nbit]).reshape(n_heaps, n_chan, n_pol, HEAP, 2).to(torch.float32)
    x = torch.complex(words[..., 0], words[..., 1])  # (H, F, P, 32)
    return x.permute(2, 1, 0, 3).reshape(n_pol, n_chan, n_heaps * HEAP)


def dada_pack_core(x: torch.Tensor, nbit: int, scale: float = 1.0) -> torch.Tensor:
    """Plain version of :func:`dada_pack`."""
    v = torch.view_as_real(x.permute(2, 1, 0)) * torch.tensor(scale, dtype=torch.float32)
    if nbit in CLIP:
        v = torch.round(v).clamp(*CLIP[nbit])
    return v.to(WORDS[nbit]).contiguous().view(torch.uint8).reshape(-1)


# --- the kernels ---------------------------------------------------------------

@kernel("dada_unpack")
def dada_unpack(raw: torch.Tensor, nbit: int, n_pol: int, n_chan: int,
                count: int) -> torch.Tensor:
    """The TFP words of ``count`` file samples (1-D uint8, ``count * n_pol
    * n_chan`` pairs of ``nbit``-bit words) -> complex64 (n_pol, n_chan,
    count); float64 words round to nearest. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel, which raises ValueError for
    an NBIT it does not take or raw bytes not aligned to a word pair."""
    check_nbit("dada_unpack", nbit)
    raw = _raw(raw, nbit, count * n_pol * n_chan, "raw")
    if raw.device.type == "cpu":
        return dada_unpack_core(raw, nbit, n_pol, n_chan, count)
    _aligned(raw, "dada_unpack", nbit)
    out = torch.empty((n_pol, n_chan, count), dtype=torch.complex64, device=raw.device)
    if count == 0 or n_pol * n_chan == 0:
        return out
    launch(dada_unpack, "dada_unpack_launch", raw,
           raw.data_ptr(), out.data_ptr(), nbit, n_pol, n_chan, count,
           tile_columns(n_pol * n_chan))
    return out


@kernel("lowcbf_unpack")
def lowcbf_unpack(raw: torch.Tensor, nbit: int, n_pol: int, n_chan: int,
                  n_heaps: int) -> torch.Tensor:
    """``n_heaps`` LowCBF heaps (1-D uint8; each heap ``n_chan * n_pol``
    packets of 32 word pairs, t fastest) -> complex64 (n_pol, n_chan,
    32 * n_heaps). A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel, which raises ValueError for an NBIT it does not
    take."""
    check_nbit("lowcbf_unpack", nbit)
    raw = _raw(raw, nbit, n_heaps * HEAP * n_pol * n_chan, "raw")
    if raw.device.type == "cpu":
        return lowcbf_unpack_core(raw, nbit, n_pol, n_chan, n_heaps)
    _aligned(raw, "lowcbf_unpack", nbit)
    out = torch.empty((n_pol, n_chan, n_heaps * HEAP), dtype=torch.complex64,
                      device=raw.device)
    if out.numel() == 0:
        return out
    blocks = min(-(-out.numel() // 256), LOWCBF_BLOCKS)
    launch(lowcbf_unpack, "lowcbf_unpack_launch", raw,
           raw.data_ptr(), out.data_ptr(), nbit, n_pol, n_chan, n_heaps, blocks)
    return out


@kernel("dada_pack")
def dada_pack(x: torch.Tensor, nbit: int, scale: float = 1.0) -> torch.Tensor:
    """complex64 (n_pol, n_chan, count) -> the TFP words of the file (1-D
    uint8): each component times ``scale`` (a float32 product), and for
    NBIT 8 and 16 rounded half to even and clipped to the word's range.
    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel, which raises ValueError for an NBIT it does not take."""
    check_nbit("dada_pack", nbit)
    if x.ndim != 3:
        raise ValueError(f"x must be (n_pol, n_chan, count), got {tuple(x.shape)}")
    x = require(x, "x", torch.complex64, x.device)
    if x.device.type == "cpu":
        return dada_pack_core(x, nbit, scale)
    n_pol, n_chan, count = x.shape
    raw = torch.empty(x.numel() * pair_bytes(nbit), dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return raw
    launch(dada_pack, "dada_pack_launch", x,
           x.data_ptr(), raw.data_ptr(), nbit, n_pol, n_chan, count,
           tile_columns(n_pol * n_chan), scale)
    return raw
