"""Two-stage filterbank cascades and the combined inversion under time
sharding.

Counterpart of :mod:`ska_pst_dsp_tpu.parallel.two_stage_sharded`
(TwoStageFilterBank.m:92-110, TwoStageInverseFilterBank.m:124-151,
polyphase_synthesis.m:198-238): the stage-1 coarse channelizer runs the
halo-exchange sharded analysis; stage 2 puts every coarse channel on the
analysis kernel's batch axis (as the port's ``models.two_stage`` does) and
runs the sharded plain analysis or the sharded LowCBF firmware model; the
critical chomp and the combined inversion follow the models, so the
sharded chain equals the one-shot models.

Each stage works on a global stream whose length it sets: the LowCBF
first-call pad at the front, alignment zeros at the end, the trim to the
stage's valid spectra. Those moves, which XLA makes in the JAX package at
every global pad and stage boundary (``two_stage_sharded.py:63-76``,
``:137-141``, ``:163-167``, ``:232-236``), are :func:`.sharded.reshard`
here: each stage hands the next its output with the global span each rank
holds.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from ..ops import cfft
from ..ops import lowcbf as _lowcbf
from .sharded import (
    Mesh, Span, _local, analysis_tm, clipped_spans, device_const, even_spans,
    inversion_consts, reshard, right_halo, synthesis_tm,
)

LOWCBF = "polyphase_analysis_lowcbf"


def lowcbf_tm(z: torch.Tensor, filt, mesh: Mesh, *, first_call: bool = True,
              have: Optional[Sequence[Span]] = None) -> Tuple[torch.Tensor, List[Span]]:
    """The sharded LowCBF filterbank of a (batch, n) shard whose global
    spans are ``have`` (default equal shards): time-major out (batch, rows,
    216), and the output's global spans."""
    dt = mesh.dt
    if have is None:
        have = even_spans(z.shape[-1], dt)
    front = _lowcbf.FIRST_CALL_PAD if first_call else 0
    n_dat = have[-1][1] + front
    n_out = (n_dat - _lowcbf.NFILT) // _lowcbf.STEP
    # shards 4*STEP-aligned (one quarter-turn table for all) and at least
    # NFILT long (the halo comes from one neighbour)
    unit = _lowcbf.STEP * 4
    per_rank = -(-n_dat // dt)
    shard = max(-(-per_rank // unit), -(-_lowcbf.NFILT // unit)) * unit
    z = reshard(z, [(a + front, b + front) for a, b in have], even_spans(shard, dt), mesh)
    halo = right_halo(z, _lowcbf.NFILT, mesh)
    dev = z.device
    out = _lowcbf.lowcbf_core(torch.cat([z, halo], dim=-1),
                              device_const(_lowcbf.lowcbf_filter, filt, device=dev),
                              device_const(_lowcbf.lowcbf_ramp, device=dev),
                              device_const(_lowcbf.kept_bins, device=dev), False)
    spans = clipped_spans(shard // _lowcbf.STEP, dt, n_out)
    a, b = spans[mesh.t]
    return out[:, :b - a], spans


def sharded_lowcbf_analysis(x, filt, mesh: Mesh, *, first_call: bool = True):
    """Time-sharded LowCBF firmware-model filterbank
    (polyphase_analysis_lowcbf.m:16-48).

    x: the rank's (batch, n_local) shard of the global (batch, n_dat)
    stream. The first-call pad (1536 zeros at the front) and the alignment
    pad are global; the re-split shards are multiples of 4*STEP, so every
    rank shares one quarter-turn table. Returns (batch, 216, rows): global
    spectra ``[t * m, (t + 1) * m)`` of the (batch, 216, n_out) output cut
    at n_out, so the last ranks hold fewer, maybe none. Same kind as the
    input."""
    z, pair = _local(x, mesh)
    out, _ = lowcbf_tm(z, filt, mesh, first_call=first_call)
    return cfft.same_kind(out.transpose(1, 2), pair)


def _plain_stage(z, have, filt, n_chan, os_f, mesh):
    """A plain analysis stage on a shard with global spans ``have``: pad
    to the sharding quantum, re-split, analyse, cut at the valid spectra."""
    dt = mesh.dt
    n_dat = have[-1][1]
    step = geometry.analysis_step(n_chan, os_f)
    quantum = dt * step * os_f.nu
    padded = -(-n_dat // quantum) * quantum
    z = reshard(z, have, even_spans(padded // dt, dt), mesh)
    out = analysis_tm(z, filt, n_chan, os_f, mesh)
    nb = (n_dat - geometry.padded_filter_length(np.asarray(filt).size, n_chan)) // step
    spans = clipped_spans(out.shape[1], dt, nb)
    a, b = spans[mesh.t]
    return out[:, :b - a], spans


def sharded_two_stage_round_trip(x, cfg1, cfg2, mesh: Mesh, *, critical: bool = True,
                                 combine: int = 1, invert: bool = True):
    """Stage-1 analysis -> batched stage 2 (plain or LowCBF) -> critical
    chomp -> combined stage-2 Golden inversion, all time-sharded.

    x: the rank's (n_pol, n_local) shard of the global stream. Returns the
    rank's slice of the global (n_pol, n_coarse_out, T_out) inversion, or,
    with ``invert=False``, of the channelized (n_pol, c1 * nch2, T2); the
    slices are consecutive in rank order (the last ranks' may be shorter).
    Mirrors ``models.two_stage``'s array semantics."""
    os1 = Rational.coerce(cfg1.os_factor)
    os2 = Rational.coerce(cfg2.os_factor)
    filt1 = cfg1.load_fir_filter_coeff()
    filt2 = cfg2.load_fir_filter_coeff()
    z, pair = _local(x, mesh)
    n_pol = z.shape[0]
    have = even_spans(z.shape[-1], mesh.dt)

    # stage 1: the coarse channelizer, time-major (n_pol, T1, c1)
    if cfg1.analysis_function == LOWCBF:
        s1, spans1 = lowcbf_tm(z, filt1, mesh, first_call=True, have=have)
    else:
        s1, spans1 = _plain_stage(z, have, filt1, cfg1.channels, os1, mesh)
    c1 = s1.shape[2]

    # stage 2: coarse channels ride the batch axis (the corner turn)
    streams = s1.permute(0, 2, 1).reshape(n_pol * c1, s1.shape[1])
    use_lowcbf = cfg2.analysis_function == LOWCBF
    if use_lowcbf:
        s2, spans2 = lowcbf_tm(streams, filt2, mesh, first_call=True, have=spans1)
    else:
        s2, spans2 = _plain_stage(streams, spans1, filt2, cfg2.channels, os2, mesh)
    nch2_orig = s2.shape[2]
    t2, t2_local = spans2[-1][1], s2.shape[1]
    s2 = s2.reshape(n_pol, c1, t2_local, nch2_orig)

    # the critical chomp (TwoStageFilterBank.m:102-105); the target is
    # stage 1's critical ratio, a no-op for the LowCBF stage 2
    nch2 = os1.normalize(cfg2.channels) if critical else nch2_orig
    offset = nch2_orig - nch2
    if critical and offset > 0:
        if use_lowcbf:
            # monotonic KEPT stream: the band edges go, offset/2 each end
            s2 = s2[..., offset // 2: offset // 2 + nch2]
        else:
            half = nch2 // 2
            s2 = torch.cat([s2[..., :half - 1], s2[..., half - 1 + offset: nch2 + offset]],
                           dim=-1)
    # (n_pol, c1 * nch2, T2) channel-major, as the JAX chain
    chans = s2.permute(0, 1, 3, 2).reshape(n_pol, c1 * nch2, t2_local)
    if not invert:
        return cfft.same_kind(chans, pair)

    # the combined stage-2 inversion (models.two_stage's detection)
    if nch2 == os2.normalize(cfg2.channels):
        inv_critical = True
    elif nch2 == cfg2.channels:
        inv_critical = False
        if combine > 1:
            raise ValueError("cannot combine oversampled coarse channels")
    else:
        raise ValueError(f"invalid per-coarse channel count {nch2} for inversion")
    nch_in = nch2 * combine
    nch_out = (c1 * nch2) // nch_in
    # c1 need not divide into combine slabs (lowpsi: 216 % 16): the tail
    # coarse channels go, as in models.two_stage
    slabs = chans[:, : nch_out * nch_in].reshape(n_pol * nch_out, nch_in, t2_local)
    L2, ov2 = cfg2.input_fft_length, cfg2.input_overlap
    geom2 = geometry.SynthesisGeometry(nch_in, L2, ov2, os2)
    quantum = mesh.dt * geom2.input_keep
    padded = -(-t2 // quantum) * quantum
    slabs = reshard(slabs, spans2, even_spans(padded // mesh.dt, mesh.dt), mesh)
    c = inversion_consts(nch_in, L2, os2, ov2, slabs.device, spans_nyquist=not inv_critical,
                         deripple_coeff=filt2 if cfg2.deripple else None,
                         temporal_taper=cfg2.temporal_taper, combine=combine,
                         monotonic=use_lowcbf)
    inv = synthesis_tm(slabs.transpose(1, 2), c, geom2, mesh,
                       spans_nyquist=not inv_critical,
                       valid=geom2.n_blocks(t2) * geom2.output_keep)
    return cfft.same_kind(inv.reshape(n_pol, nch_out, -1), pair)
