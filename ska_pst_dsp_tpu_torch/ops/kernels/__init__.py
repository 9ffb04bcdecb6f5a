"""Hand-written CUDA kernels of the fused SKA-Low and SKA-Mid round trips.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas`. Each kernel module holds a
wrapper that launches its kernel for a CUDA tensor and runs the plain
PyTorch version beside it for a CPU tensor (the only reason it ever takes
the plain path), an integer ``launches`` counter on the wrapper that goes
up by one each time the kernel is launched, and a pure predicate ``takes``
that says which geometries the card has an instantiated kernel for. On a
CUDA tensor the wrapper raises ValueError from that predicate, and so do the
public drop-in functions (``polyphase_*_fused``, ``fused_inversion``) built
on it: nothing on the card gives way to the plain version:

* :mod:`.analysis_fused`  — fold + DFT + derotation ramp;
* :mod:`.synthesis_fused` — inversion frontend, and the epilogue dispatch;
* :mod:`.ifft_fused`      — the inversion's backward-FFT epilogue, one
  thread-block cluster per transform;
* :mod:`.analysis_padded_fused` — the zero-padded (SKA-Mid) analysis fold,
  one persistent launch on asynchronous bulk copies;
* :mod:`.chan_dft_fused`  — mid's channel DFT + derotation constant;
* :mod:`.ifft_big`        — mid's out-of-core epilogue (two launches);
* :mod:`.dada_unpack`     — the DADA ingest engine's unpacks (file words
  to complex64 planes, TFP and LowCBF) and pack (the write side), which
  replace the JAX package's host C++ engine, not a Pallas kernel;
* :mod:`.inversion_fused` — the SKA-Low inversion's frontend and cluster
  epilogue in one kernel, the assembled spectra kept in the cluster's
  shared memory (fuses two Pallas kernels' ports; replaces neither alone).

The sources live in ``ska_pst_dsp_tpu_torch/csrc/``; :mod:`._build` compiles
them on first use. This module holds what the wrappers share: their
registry and one launch path (:func:`kernel`, :func:`launch`), the
odd-factor split of a transform length, exact phase tables, the plan and
twiddle tables of the register passes (``csrc/fft_reg.cuh``) that every
kernel with a DFT runs on, and the N-level twiddles of the two cluster
kernels.
"""

from __future__ import annotations

import ctypes
import functools
import importlib
import pkgutil
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ska_pst_dsp_tpu_torch.utils.profiling import spanned

from . import _build

#: shared memory one thread block may use on the H100 (bytes)
SMEM_LIMIT = 232_448

#: odd factors of a transform length n = r * 2^k the port splits off:
#: csrc/ifft_big.cu's radix-r step takes all three, analysis_fused's and
#: chan_dft_fused's are instantiated for r in {1, 3}
RADICES = (1, 3, 7)


#: the kernel wrappers by key, each registered by :func:`kernel` as its
#: module loads
_WRAPPERS: Dict[str, Callable] = {}


def wrappers() -> Dict[str, Callable]:
    """The eleven kernels' wrappers, every one with its ``launches``
    counter: the seven by the name of the Pallas kernel each replaces, the
    ingest engine's three and the fused SKA-Low inversion. Loads every
    kernel module the first time, then returns the registry."""
    _load_modules()
    return _WRAPPERS


@functools.lru_cache(maxsize=None)
def _load_modules() -> None:
    for module in pkgutil.iter_modules(__path__):
        importlib.import_module(f"{__name__}.{module.name}")


def kernel(key: str, plain: Optional[Callable] = None):
    """Decorator of a kernel wrapper: registers it under ``key`` in
    :func:`wrappers`, makes its call the span ``kernel.<key>`` and starts
    its ``launches`` counter at 0. Given ``plain``, the plain version with
    the wrapper's own signature, a CPU tensor as the first argument runs
    that in place of the wrapper's body; a wrapper whose CPU branch does
    more keeps it in its body."""
    def register(body: Callable) -> Callable:
        fn = body
        if plain is not None:
            @functools.wraps(body)
            def fn(x, *args, **kwargs):
                return (plain if x.device.type == "cpu" else body)(x, *args, **kwargs)
        wrapper = spanned("kernel." + key)(fn)
        wrapper.launches = 0
        _WRAPPERS[key] = wrapper
        return wrapper
    return register


def on_card(name: str, device: torch.device) -> torch.device:
    """``device`` where it is a card. Any other raises the one ValueError of
    the wrappers, naming ``name``: the CPU runs the plain versions before
    this is asked, and a wrapper asks only at its launch, after its own
    checks, so that a geometry no kernel takes is refused first."""
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    return device


def _call(name: str, entry: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        status = getattr(_build.library(), entry)(*args)
    _build.check(status, name)


def launch(wrapper: Callable, entry: str, t: torch.Tensor, *args) -> None:
    """Launch ``wrapper``'s C entry ``entry`` of the built library on t's
    card: ``args``, then the current stream of that card. Raises as
    :func:`on_card` off the card and RuntimeError, naming the wrapper,
    where the launch fails; only a launch that succeeds adds one to
    ``wrapper.launches``."""
    name = wrapper.__name__
    _call(name, entry, on_card(name, t.device), *args, stream_of(t))
    wrapper.launches += 1


def query(entry: str, device: torch.device, *args) -> int:
    """The int the library's C query ``entry`` writes after ``args`` on
    ``device``'s card (the current card for ``torch.device("cuda")``): a
    kernel's resident blocks or clusters. Not a launch; nothing counts it."""
    out = ctypes.c_int(0)
    _call(entry, entry, on_card(entry, device), *args, ctypes.byref(out))
    return out.value


def radix(n: int) -> Tuple[int, int, int]:
    """(r, q, log2 q) with n = r * q, q = 2^log2q and r odd: the radix-r
    step and the power-of-two transform of a kernel's DFT."""
    if n <= 0:
        raise ValueError(f"DFT length must be positive, got {n}")
    logq = (n & -n).bit_length() - 1
    r = n >> logq
    if r not in RADICES:
        raise ValueError(
            f"DFT length {n} = {r} * 2^{logq}: the kernels take odd factors "
            f"{RADICES} only"
        )
    return r, 1 << logq, logq


def twiddle_table(n: int, sign: int) -> np.ndarray:
    """(n,) complex64 table exp(sign * 2*pi*i*m/n), m = 0..n-1, computed in
    float64 from the exact integer m."""
    m = np.arange(n, dtype=np.float64)
    return np.exp(sign * 2j * np.pi * m / n).astype(np.complex64)


def phase_table(idx, n: int, sign: int) -> np.ndarray:
    """exp(sign * 2*pi*i*idx/n) as complex64 for integer ``idx`` of any
    shape, the angle taken in float64 from the exact integer idx mod n."""
    return np.exp(sign * 2j * np.pi * (np.asarray(idx, np.int64) % n) / n).astype(np.complex64)


def reg_plan(q: int) -> Tuple[int, int]:
    """(passes, last radix) of a q-point transform on csrc/fft_reg.cuh's
    register passes (FftRegPlan): ceil(log2(q) / 3) passes, all of radix 8
    but the last, of radix 2, 4 or 8. q = 2^k, 128 <= q <= 4096."""
    logq = q.bit_length() - 1
    if q != 1 << logq or not 7 <= logq <= 12:
        raise ValueError(f"register-pass transforms take 2^7..2^12 points, got {q}")
    passes = -(-logq // 3)
    return passes, q >> (3 * (passes - 1))


def pass_twiddles(q: int, sign: int) -> np.ndarray:
    """The per-pass twiddle table of a q-point transform of sign ``sign`` on
    the register passes (csrc/fft_reg.cuh fft_reg_pass_tw): for each radix-8
    pass s but the last, of span h = q / 8^(s+1), 7 rows d = 1..7 of h
    entries exp(sign * 2*pi*i*j*d/(8h)), j < h. complex64, each angle taken
    in float64 from the exact integer j*d; q - (last radix) entries."""
    passes, last = reg_plan(q)
    parts = []
    for s in range(passes - 1):
        h = q >> (3 * (s + 1))
        jd = np.arange(1, 8)[:, None] * np.arange(h)[None, :]
        parts.append(np.exp(sign * 2j * np.pi * jd / (8 * h)).ravel())
    out = np.concatenate(parts).astype(np.complex64)
    assert out.size == q - last
    return out


@functools.lru_cache(maxsize=None)
def device_pass_twiddles(q: int, sign: int, device: torch.device) -> torch.Tensor:
    """:func:`pass_twiddles` on ``device``, built once per (q, sign, device)."""
    return torch.as_tensor(pass_twiddles(q, sign), device=device)


@functools.lru_cache(maxsize=None)
def twiddles(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """:func:`twiddle_table` on ``device``, built once per (n, sign, device)."""
    return torch.as_tensor(twiddle_table(n, sign), device=device)


def cluster_twiddles(n: int, n2: int, n1: int, split: int) -> Dict[str, np.ndarray]:
    """The tables of an n = n2 * n1-point backward transform on a cluster
    kernel (:mod:`.ifft_fused`, :mod:`.inversion_fused`), complex64, each
    built in float64 from exact integers: ``tw_n1`` (w_n1^m) and ``tw_a``,
    ``tw_b`` ((n2 / S, n1) w_N^(S*a*m1) and (S, n1) w_N^(b*m1), S =
    ``split``: the N-level twiddle of k2 = S*a + b is their product)."""
    m1 = np.arange(n1, dtype=np.int64)[None, :]
    return {
        "tw_n1": twiddle_table(n1, 1),
        "tw_a": phase_table(split * np.arange(n2 // split)[:, None] * m1, n, 1),
        "tw_b": phase_table(np.arange(split)[:, None] * m1, n, 1),
    }


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Check a kernel operand's dtype and device; return it contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    return t.contiguous()


#: the current stream's raw handle by device index, without building a
#: torch.cuda.Stream (a few microseconds a call); None where torch lacks it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream of t's device."""
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream
