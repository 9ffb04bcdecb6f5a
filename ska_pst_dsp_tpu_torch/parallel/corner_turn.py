"""The ('chan', 'time') mesh: channel-sharded analysis and the all-to-all
corner-turn inversion.

Counterpart of :mod:`ska_pst_dsp_tpu.parallel.corner_turn`. The Golden
inversion has two phases with opposite natural layouts: the per-channel
forward FFTs, passband keep and deripple (channel parallel), then the
full-band assembly and the big backward FFT, which needs every channel of a
block. On a ``dc x dt`` mesh phase 1 runs on the rank's channel slice and
time shard, an all-to-all over the channel group redistributes from
channel-sharded to block-sharded, and phase 2 runs on whole spectra: the
channel/time corner turn the reference does as an in-memory transpose
(polyphase_synthesis.m:171-184, 253-278).

The JAX package's 2-D analysis shards the columns of a DFT matrix over the
channel axis, because its DFT is a matmul on the TPU's matrix unit. Here
each rank runs the analysis kernel (fold, FFT, ramp) on its time shard plus
halo for all channels and keeps its channel slice: the full DFT is computed
on each of the ``dc`` ranks of a time group. That costs less than the
column-sliced matmul: at block 256 a 256-point FFT per spectrum is about
10 kflop, against 8 * 256 * 128 = 262 kflop for half the matrix.

Layouts, as ``PartitionSpec``s of the JAX package: the analyses return
``P(None, 'chan', 'time')`` (rank (c, t) holds channels ``[c * cs, (c + 1)
* cs)`` of time shard t), the inversion returns ``P(None, None, ('time',
'chan'))`` (rank (c, t) holds output chunk ``t * dc + c``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from ..ops import cfft
from ..ops.kernels.synthesis_fused import epilogue_dispatch, synthesis_fused
from .sharded import (
    Mesh, _local, _round_trip_synthesis, analysis_padded_tm, analysis_tm, default_device,
    inversion_consts, right_halo, roll_time, trim_local,
)


def make_mesh_2d(n_chan_devices: int, n_time_devices: int, *, device=None) -> Mesh:
    """The ('chan', 'time') mesh over the default process group, whose size
    must be ``n_chan_devices * n_time_devices``: rank r sits at ``(c, t) =
    divmod(r, n_time_devices)``. Every rank creates every group (a
    collective call), so every rank calls this in the same order."""
    dc, dt = n_chan_devices, n_time_devices
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if dc * dt != world:
        raise ValueError(f"a {dc} x {dt} mesh needs {dc * dt} ranks, the process group has {world}")
    if not initialized:
        return Mesh(1, 1, 0, default_device(0) if device is None else device, None)
    rank = dist.get_rank()
    time_group = chan_group = None
    for c in range(dc):
        g = dist.new_group([c * dt + t for t in range(dt)])
        if rank // dt == c:
            time_group = g
    for t in range(dt):
        g = dist.new_group([c * dt + t for c in range(dc)])
        if rank % dt == t:
            chan_group = g
    return Mesh(dc, dt, rank, default_device(rank) if device is None else device,
                dist.get_backend(), time_group=time_group, chan_group=chan_group)


def _channel_slice(block: int, mesh: Mesh) -> slice:
    if block % mesh.dc:
        raise ValueError(f"block={block} not divisible by chan axis {mesh.dc}")
    cs = block // mesh.dc
    return slice(mesh.c * cs, (mesh.c + 1) * cs)


def sharded_polyphase_analysis_2d(x, filt, block: int, os_factor, mesh: Mesh):
    """Single-stage analysis PFB on a ('chan', 'time') mesh.

    x: time shard t of the global (n_pol, n_dat) stream on rank (c, t), the
    same on every c; its length a multiple of step*nu. The time group
    exchanges the filter-history halo; each rank runs the whole analysis
    and keeps its channel slice. Returns (n_pol, block // dc, n_local //
    step): channels ``[c * cs, (c + 1) * cs)``, spectra of time shard t.
    Same kind as the input."""
    os_factor = Rational.coerce(os_factor)
    z, pair = _local(x, mesh)
    sl = _channel_slice(block, mesh)
    spec = analysis_tm(z, filt, block, os_factor, mesh)
    return cfft.same_kind(spec[:, :, sl].transpose(1, 2), pair)


def _padded_2d_tm(z, filt, block, os_factor, mesh, apply_delay):
    sl = _channel_slice(block, mesh)
    spec = analysis_padded_tm(z, filt, block, os_factor, mesh)[:, :, sl]
    if apply_delay:
        delay = geometry.padded_sample_delay_shift(np.asarray(filt).size, block, os_factor)
        spec = roll_time(spec, delay, mesh)
    return spec


def sharded_polyphase_analysis_padded_2d(x, filt, block: int, os_factor, mesh: Mesh, *,
                                         apply_delay: bool = True):
    """Zero-padded (SKA-Mid) analysis PFB on a ('chan', 'time') mesh: as
    :func:`sharded_polyphase_analysis_2d`, with the padded kernels, the
    previous rank's history as halo and the group-delay roll over the
    global time axis (on the channel slice; it wraps from the first time
    shard to the last). Reference: polyphase_analysis_padded.m:113-153."""
    os_factor = Rational.coerce(os_factor)
    z, pair = _local(x, mesh)
    spec = _padded_2d_tm(z, filt, block, os_factor, mesh, apply_delay)
    return cfft.same_kind(spec.transpose(1, 2), pair)


def corner_turn(fn: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The all-to-all over the channel group: (n_pol, B, cs, fnw) of the
    rank's channel slice for the time shard's B blocks -> (n_pol, B // dc,
    dc * cs, fnw), block chunk c of every channel slice, channels in order
    (``corner_turn.py:287-295``)."""
    n_pol, n_b, cs, fnw = fn.shape
    dc, c = mesh.dc, mesh.c
    b = n_b // dc
    out = fn.new_empty((n_pol, b, dc * cs, fnw))
    out[:, :, c * cs:(c + 1) * cs] = fn[:, c * b:(c + 1) * b]
    if dc > 1:
        got = mesh._all_to_all(
            "all_to_all", mesh.chan_group,
            [None if d == c else fn[:, d * b:(d + 1) * b] for d in range(dc)],
            [None if s == c else (n_pol, b, cs, fnw) for s in range(dc)], fn.dtype)
        for s, piece in enumerate(got):
            if piece is not None:
                out[:, :, s * cs:(s + 1) * cs] = piece
    return out


def synthesis_2d_tm(x_tc: torch.Tensor, c, geom: geometry.SynthesisGeometry, mesh: Mesh, *,
                    spans_nyquist: bool) -> torch.Tensor:
    """The corner-turn inversion of a time-major (n_pol, n_local, cs)
    shard; returns rank (c, t)'s (n_pol, 1, B // dc * output_keep) output
    chunk ``t * dc + c``, cut at the one-shot count."""
    n_pol, n_local, cs = x_tc.shape
    keep, dc = geom.input_keep, mesh.dc
    if n_local <= 0 or n_local % keep:
        raise ValueError(f"time shard {n_local} must be a multiple of input_keep={keep}")
    n_b = n_local // keep
    if n_b % dc:
        raise ValueError(
            f"blocks per time shard ({n_b}) must be divisible by the chan axis ({dc})"
        )
    L = geom.input_fft_length
    halo = right_halo(x_tc, 2 * geom.input_overlap, mesh, dim=1)
    # phase 1, channel-local: frames, taper, FFT, keep, deripple; the
    # Nyquist roll, spectral taper and gain ride the epilogue's constants
    perm = torch.arange(cs, dtype=torch.int32, device=x_tc.device)
    fn = synthesis_fused(torch.cat([x_tc, halo], dim=1), c["t_taper"], c["dr"], perm, L,
                         keep, (L // 2 + geom.discard) % L, n_b)
    turned = corner_turn(fn, mesh)
    # phase 2, block-local on whole spectra
    b = n_b // dc
    out = epilogue_dispatch(turned.reshape(n_pol, b, geom.output_fft_length), c["elem"],
                            geom, spans_nyquist=spans_nyquist, n_valid=b)
    out = out.reshape(n_pol, 1, -1)
    valid = geom.n_blocks(n_local * mesh.dt) * geom.output_keep
    return trim_local(out, (mesh.t * dc + mesh.c) * out.shape[-1], valid)


def sharded_polyphase_synthesis_2d(
    x,
    input_fft_length: int,
    os_factor,
    mesh: Mesh,
    *,
    input_overlap: Optional[int] = None,
    deripple_coeff=None,
    temporal_taper: str = "no_window",
    spectral_taper: str = "no_window",
    spans_nyquist: bool = True,
):
    """Golden inversion on a ('chan', 'time') mesh.

    x: rank (c, t)'s (n_pol, n_chan // dc, n_local) block of the global
    (n_pol, n_chan, n_dat) fine channels (``P(None, 'chan', 'time')``),
    n_local a multiple of input_keep whose block count divides by dc.
    Phase 1 runs the frontend kernel on the channel slice, the all-to-all
    gathers every channel of block chunk c, phase 2 runs the epilogue
    dispatch on whole spectra. Returns (n_pol, 1, n_local // keep // dc *
    output_keep), output chunk ``t * dc + c`` of the global inversion
    (``P(None, None, ('time', 'chan'))``), which equals the one-shot
    kernel's; the last chunk is cut at the one-shot count."""
    os_factor = Rational.coerce(os_factor)
    z, pair = cfft.as_complex(x)
    z = z.to(mesh.device)
    n_chan = z.shape[1] * mesh.dc
    L = input_fft_length
    if input_overlap is None:
        input_overlap = L // 8
    geom = geometry.SynthesisGeometry(n_chan, L, input_overlap, os_factor)
    c = inversion_consts(n_chan, L, os_factor, input_overlap, z.device,
                         spans_nyquist=spans_nyquist, deripple_coeff=deripple_coeff,
                         temporal_taper=temporal_taper, spectral_taper=spectral_taper)
    out = synthesis_2d_tm(z.transpose(1, 2), c, geom, mesh, spans_nyquist=spans_nyquist)
    return cfft.same_kind(out, pair)


def sharded_round_trip_2d(x, filt, n_chan: int, os_factor, input_fft_length: int,
                          input_overlap: int, mesh: Mesh, *, temporal_taper: str = "tukey",
                          deripple: bool = True):
    """Channel x time-sharded analysis, then the corner-turn inversion. x:
    time shard t on rank (c, t); returns output chunk ``t * dc + c`` of the
    one-shot chain's inversion. The fine channels never leave their
    ``P(None, 'chan', 'time')`` layout between the stages."""
    os_factor = Rational.coerce(os_factor)
    z, pair = _local(x, mesh)
    sl = _channel_slice(n_chan, mesh)
    spec = analysis_tm(z, filt, n_chan, os_factor, mesh)[:, :, sl]
    t_valid = geometry.analysis_nblocks(z.shape[-1] * mesh.dt, np.asarray(filt).size,
                                        n_chan, os_factor)
    out = _round_trip_synthesis(spec, t_valid, filt, n_chan, os_factor, input_fft_length,
                                input_overlap, mesh, temporal_taper, deripple,
                                invert=synthesis_2d_tm, blocks_multiple=mesh.dc)
    return cfft.same_kind(out, pair)


def sharded_round_trip_2d_padded(x, filt, n_chan: int, os_factor, input_fft_length: int,
                                 input_overlap: int, mesh: Mesh, *,
                                 temporal_taper: str = "tukey", deripple: bool = True):
    """:func:`sharded_round_trip_2d` with the zero-padded (SKA-Mid)
    analysis and its group-delay roll."""
    os_factor = Rational.coerce(os_factor)
    z, pair = _local(x, mesh)
    spec = _padded_2d_tm(z, filt, n_chan, os_factor, mesh, True)
    t_valid = z.shape[-1] * mesh.dt // geometry.analysis_step(n_chan, os_factor)
    out = _round_trip_synthesis(spec, t_valid, filt, n_chan, os_factor, input_fft_length,
                                input_overlap, mesh, temporal_taper, deripple,
                                invert=synthesis_2d_tm, blocks_multiple=mesh.dc)
    return cfft.same_kind(out, pair)
