"""Complex FFT helpers on ``torch.complex64``.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.cfft` (its public helpers at
cfft.py:279-340). The JAX module runs DFTs as split re/im matmuls because
the TPU has neither a complex dtype nor an FFT op; the GPU has both, so here
every helper is a thin layer over ``torch.fft``. Each takes a complex tensor
or an ``(re, im)`` float32 pair and returns the same kind.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]
Complexish = Union[torch.Tensor, Pair]


def split(x) -> Pair:
    """Complex (torch or numpy) -> (re, im) float32 tensors; a real input
    gets a zero imaginary part."""
    x = torch.as_tensor(x)
    if x.is_complex():
        x = x.to(torch.complex64)
        return x.real.contiguous(), x.imag.contiguous()
    x = x.to(torch.float32)
    return x, torch.zeros_like(x)


def combine(xr, xi) -> torch.Tensor:
    """(re, im) -> complex64 tensor."""
    return torch.complex(
        torch.as_tensor(xr, dtype=torch.float32),
        torch.as_tensor(xi, dtype=torch.float32),
    )


def as_complex(x) -> Tuple[torch.Tensor, bool]:
    """Complex64 view of a complex tensor/array or an (re, im) pair, and
    whether it came as a pair (so the result can be returned as one)."""
    if isinstance(x, tuple):
        return combine(*x), True
    x = torch.as_tensor(x)
    if not x.is_complex():
        x = combine(x, torch.zeros_like(x, dtype=torch.float32))
    return x.to(torch.complex64), False


def same_kind(y: torch.Tensor, pair: bool) -> Complexish:
    return (y.real, y.imag) if pair else y


def fft(x: Complexish, axis: int = -1) -> Complexish:
    """Forward DFT along ``axis``."""
    z, pair = as_complex(x)
    return same_kind(torch.fft.fft(z, dim=axis), pair)


def ifft(x: Complexish, axis: int = -1) -> Complexish:
    """Inverse DFT (1/N normalised) along ``axis``."""
    z, pair = as_complex(x)
    return same_kind(torch.fft.ifft(z, dim=axis), pair)


def fftshift(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Swap spectrum halves (a roll by n//2)."""
    return torch.roll(x, x.shape[axis] // 2, dims=axis)


def cmul(a: Complexish, b: Complexish) -> Complexish:
    """Complex product; pairs in -> pair out."""
    za, pair = as_complex(a)
    zb, _ = as_complex(b)
    return same_kind(za * zb, pair)
