"""Fused Golden-inversion frontend kernel and the epilogue dispatch.

Counterpart of :mod:`ska_pst_dsp_tpu.ops.pallas.synthesis_fused`. The CUDA
kernel (``csrc/synthesis_fused.cu``) loads each overlap-save frame of a
tile of 32 channels straight into registers, tapers it there, runs the
L-point FFT as register radix-8 passes (``csrc/fft_reg.cuh``) and stores
only the kept, derippled passband bins, already in assembled spectrum order
(n_pol, n_blocks, n_chan, FN_width). Its plain version is
:func:`ska_pst_dsp_tpu_torch.ops.synthesis.frontend`.

At SKA-Low's geometry and a LowCBF PST slab's (216 kept channels)
:func:`fused_inversion` runs neither this kernel nor an epilogue but
:mod:`.inversion_fused`, which fuses the two so that the assembled spectra
stay in a thread-block cluster's shared memory; the choice is
:func:`.inversion_fused.takes`, made before anything is launched.
Elsewhere the frontend kernel runs, then the epilogue on the route
:func:`epilogue_plan` chooses once per length, after the JAX package's
dispatch (synthesis_fused.py:419-427): the fused epilogue
(:mod:`.ifft_fused`) where :func:`.ifft_fused.plan_ifft` applies (low);
else the out-of-core pair (:mod:`.ifft_big`) where
:func:`.ifft_big.plan_big_ifft` applies (mid's 1.8M-point IFFT); otherwise,
as there, the composed epilogue. On the card a :func:`plan_ifft` split the
cluster kernel is not instantiated for goes to the out-of-core pair where
that has kernels for it (512 channels at 4/3: 98304 = 256 * 384 points do
not fit in a cluster's shared memory), else to the pair on a split of the
same length it has kernels for (256 channels at 8/7 with L 512: 114688
points, (256, 448) in the plan, 896 * 128 on the pair), and raises
ValueError where neither has one.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.profiling import span, spanned
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from .. import cfft
from ..synthesis import epilogue, frontend, synthesis_constants
from . import device_pass_twiddles, ifft_big, ifft_fused, inversion_fused, kernel, launch, require
from .ifft_big import fused_big_ifft_oc, plan_big_ifft
from .ifft_fused import fused_big_ifft, plan_ifft

#: frame lengths L the frontend kernel is instantiated for, with log2 L
#: (csrc/synthesis_fused.cu pick_kernel)
LENGTHS = {128: 7, 256: 8, 512: 9}


def takes(L: int) -> bool:
    """Whether the card has a frontend kernel for frame length L."""
    return L in LENGTHS


@kernel("synthesis_fused", plain=frontend)
def synthesis_fused(x_tc: torch.Tensor, t_taper: torch.Tensor, dr: torch.Tensor,
                    perm: torch.Tensor, L: int, keep: int, kpos: int,
                    n_blocks: int) -> torch.Tensor:
    """(n_pol, n_dat, n_chan) complex64, any strides -> (n_pol, n_blocks,
    n_chan, FN_width). Output channel c reads input channel perm[c]
    (int32); kept bin j is raw DFT bin (kpos + j) mod L times dr[j]. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel, which
    takes L in 128, 256 and 512 and raises ValueError for any other."""
    if not takes(L):
        raise ValueError(
            f"synthesis_fused takes L in {sorted(LENGTHS)} on the card, got {L}"
        )
    dev = x_tc.device
    if x_tc.dtype != torch.complex64 or x_tc.ndim != 3:
        raise TypeError("x must be a (n_pol, n_dat, n_chan) complex64 tensor")
    t_taper = require(t_taper, "t_taper", torch.float32, dev)
    dr = require(dr, "dr", torch.float32, dev)
    perm = require(perm, "perm", torch.int32, dev)
    n_pol, n_dat, n_chan = x_tc.shape
    fnw = dr.shape[0]
    if t_taper.shape != (L,) or perm.shape != (n_chan,) or fnw > L:
        raise ValueError("t_taper must be (L,), perm (n_chan,), FN_width <= L")
    if n_blocks <= 0 or (n_blocks - 1) * keep + L > n_dat:
        raise ValueError(
            f"{n_blocks} overlap-save blocks of {L} at hop {keep} do not fit "
            f"in {n_dat} samples"
        )
    out = torch.empty((n_pol, n_blocks, n_chan, fnw), dtype=torch.complex64,
                      device=dev)
    tab = device_pass_twiddles(L, -1, dev)
    sp, st, sc = x_tc.stride()
    launch(synthesis_fused, "synthesis_fused_launch", x_tc,
           x_tc.data_ptr(), out.data_ptr(), t_taper.data_ptr(), dr.data_ptr(),
           perm.data_ptr(), tab.data_ptr(), sp, st, sc, n_pol, n_chan,
           n_blocks, L, LENGTHS[L], keep, kpos % L, fnw)
    return out


@functools.lru_cache(maxsize=None)
def epilogue_plan(n: int, lo: int) -> Tuple[str, Optional[int], Optional[int]]:
    """(route, n2, n1): the epilogue of an n-point inversion block with
    overlap lo and its split n = n2 * n1, decided once per (n, lo).
    ("cluster", :func:`.ifft_fused.plan_ifft`'s split) where the cluster
    kernel takes it; ("composed", None, None) where neither that plan nor
    :func:`.ifft_big.plan_big_ifft` applies; else ("pair", split) on the
    first split the out-of-core pair has kernels for, with the overlap and
    the keep region whole n2 rows: the plan_ifft split, plan_big_ifft's
    p*q by n1, then n1 in 512, 384, 256, 128 (589824 = 1152 * 512 points,
    the critical inversion of 3072 channels, becomes 1536 * 384: an
    1152-point inner transform is 9 * 128, no split of the inner kernel).
    Where the pair has none, the plan_ifft split on the cluster kernel,
    else plan_big_ifft's on the pair: the wrapper then raises on the card.
    Any split gives the same transform."""
    plan, big = plan_ifft(n, lo), plan_big_ifft(n, lo)
    if plan is not None and ifft_fused.takes(*plan):
        return ("cluster", *plan)
    if plan is None and big is None:
        return "composed", None, None
    big_split = None if big is None else (big[0] * big[1], big[2])
    splits = [s for s in (plan, big_split) if s is not None]
    splits += [(n // n1, n1) for n1 in (512, 384, 256, 128) if n % n1 == 0]
    pair = next(((n2, n1) for n2, n1 in splits if ifft_big.takes(n2, n1)
                 and lo % n2 == 0 and (n - 2 * lo) % n2 == 0), None)
    if pair is not None:
        return ("pair", *pair)
    return ("cluster", *plan) if plan is not None else ("pair", *big_split)


def epilogue_dispatch(flat: torch.Tensor, elem: Optional[torch.Tensor],
                      geom: geometry.SynthesisGeometry, *, spans_nyquist: bool,
                      n_valid: int) -> torch.Tensor:
    """The inversion's epilogue on assembled spectra: (n_pol, B >= n_valid,
    N) -> (n_pol, n_valid, N - 2 * output_overlap), on the route
    :func:`epilogue_plan` gives (its lookup is the ``dispatch`` span), then
    called after that span has ended; where no plan applies, the composed
    epilogue, as in the JAX package (the ``composed_epilogue`` span),
    counted in ``fused_inversion.composed_epilogues``. ``elem`` as in
    :func:`fused_inversion`: the composed epilogue takes a (rows, N) table,
    the two kernel routes one (N,) factor. On the card a split no kernel
    takes raises ValueError."""
    n = geom.output_fft_length
    lo = geom.output_overlap
    roll, gain = _roll_gain(geom, spans_nyquist)
    with span("dispatch"):
        route, n2, n1 = epilogue_plan(n, lo)
    if route == "cluster":
        return fused_big_ifft(flat, elem, shape_key=(n, n2, n1, lo, roll, gain),
                              n_valid=n_valid)
    if route == "pair":
        return fused_big_ifft_oc(flat[:, :n_valid], elem,
                                 shape_key=(n, 1, n2, n1, lo, roll, gain))
    fused_inversion.composed_epilogues += 1
    with span("composed_epilogue"):
        return epilogue(flat, elem, lo, roll, gain, n_valid)


def _roll_gain(geom: geometry.SynthesisGeometry, spans_nyquist: bool) -> Tuple[int, float]:
    """The epilogue's DC-centering roll and its gain."""
    return (geom.fn_width // 2 if spans_nyquist else 0,
            geom.os_factor.de / geom.os_factor.nu)


@spanned("inversion")
def fused_inversion(x_tc: torch.Tensor, t_taper: torch.Tensor, dr: torch.Tensor,
                    perm: torch.Tensor, elem: Optional[torch.Tensor],
                    geom: geometry.SynthesisGeometry, *, spans_nyquist: bool,
                    valid_len: Optional[int] = None,
                    held: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused kernel (:mod:`.inversion_fused`) where
    :func:`.inversion_fused.takes` the geometry (SKA-Low, a LowCBF PST
    slab); elsewhere the frontend kernel + :func:`epilogue_dispatch`. On a (n_pol, n_dat,
    n_chan) view; the first ``valid_len`` samples (default all) are data.
    ``held``: None, or a (n_pol, h, n_chan) view of samples that come
    before x_tc's, which the fused kernel reads where they lie (the input
    is held's samples then x_tc's; ``valid_len`` counts from held's first);
    the other route takes no ``held`` and raises ValueError for one.
    ``elem``: (N,), a (rows, N) table whose row ``p % rows`` stream p reads,
    or None. Returns (n_pol, 1, n_blocks * output_keep) complex64. On the
    card a frame length or a split no kernel takes raises ValueError; so
    does a (rows, N) table on the cluster epilogue or the out-of-core
    pair. Each call counts its transforms' points in
    ``fused_inversion.transform_points`` and its kept output samples in
    ``fused_inversion.output_samples``, whichever route runs them."""
    n_pol, n_dat, n_chan = x_tc.shape
    L = geom.input_fft_length
    n_dat += 0 if held is None else held.shape[1]
    if n_dat < L:
        raise ValueError(
            f"fused synthesis needs at least one frame: n_dat={n_dat} < L={L}"
        )
    n_blocks = geom.n_blocks(n_dat if valid_len is None else valid_len)
    kpos = (L // 2 + geom.discard) % L
    n, lo = geom.output_fft_length, geom.output_overlap
    if inversion_fused.takes(L, n_chan, n, lo):
        out = inversion_fused.inversion_fused(
            x_tc, t_taper, dr, perm, elem, geom.input_keep, kpos, n_blocks, lo,
            *_roll_gain(geom, spans_nyquist), held=held,
        )
        _count(n_pol * n_blocks, n, lo)
        return out.reshape(n_pol, 1, -1)
    if held is not None:
        raise ValueError(f"only the fused inversion reads held samples; {n_chan} channels "
                         f"of {n} points take the frontend kernel and an epilogue")
    fn = synthesis_fused(x_tc, t_taper, dr, perm, L, geom.input_keep, kpos, n_blocks)
    flat = fn.reshape(n_pol, n_blocks, n)
    out = epilogue_dispatch(flat, elem, geom, spans_nyquist=spans_nyquist,
                            n_valid=n_blocks)
    _count(n_pol * n_blocks, n, lo)
    return out.reshape(n_pol, 1, -1)


def _count(transforms: int, n: int, lo: int) -> None:
    """Counts ``transforms`` inversion transforms of n points, each keeping
    n - 2*lo output samples."""
    fused_inversion.transform_points += transforms * n
    fused_inversion.output_samples += transforms * (n - 2 * lo)


#: epilogues :func:`epilogue_dispatch` ran composed because neither package
#: has a plan for their length (the critical cascade's 36864 points, say):
#: the reference's own dispatch, counted so that it shows
fused_inversion.composed_epilogues = 0
#: points of every inversion transform run, on every route, and the output
#: samples they kept: what a frame length costs, as their ratio
fused_inversion.transform_points = 0
fused_inversion.output_samples = 0


def polyphase_synthesis_fused(
    x,
    input_fft_length: int,
    os_factor: Union[Rational, str],
    *,
    spans_nyquist: bool = True,
    input_overlap: Optional[int] = None,
    deripple_coeff: Optional[np.ndarray] = None,
    sample_offset: int = 0,
    temporal_taper: Union[str, np.ndarray, None] = "no_window",
    spectral_taper: Union[str, np.ndarray, None] = "no_window",
    combine: int = 1,
    spectral_filter=None,
    time_major_in: bool = False,
    valid_len: Optional[int] = None,
):
    """Drop-in for :func:`..synthesis.polyphase_synthesis` with the
    frontend and epilogue fused. Same arguments, same in/out kinds.

    ``time_major_in=True`` takes x as (n_pol, n_dat, n_chan), the fused
    analysis' output layout; ``valid_len`` marks the first ``valid_len``
    samples as data."""
    os_factor = Rational.coerce(os_factor)
    z, pair = cfft.as_complex(x)
    x_tc = z if time_major_in else z.transpose(1, 2)
    if sample_offset:
        x_tc = x_tc[:, sample_offset:, :]
    n_chan = x_tc.shape[2]
    L = input_fft_length
    if input_overlap is None:
        input_overlap = L // 8
    geom = geometry.SynthesisGeometry(n_chan, L, input_overlap, os_factor)
    c = synthesis_constants(
        n_chan, L, os_factor, input_overlap, spans_nyquist=spans_nyquist,
        deripple_coeff=deripple_coeff, temporal_taper=temporal_taper,
        spectral_taper=spectral_taper, combine=combine,
        spectral_filter=spectral_filter,
    )
    dev = z.device
    out = fused_inversion(
        x_tc,
        torch.as_tensor(c["t_taper"], device=dev),
        torch.as_tensor(c["dr"], device=dev),
        torch.as_tensor(c["perm"], device=dev),
        None if c["elem"] is None else torch.as_tensor(c["elem"], device=dev),
        geom, spans_nyquist=spans_nyquist, valid_len=valid_len,
    )
    return cfft.same_kind(out, pair)
