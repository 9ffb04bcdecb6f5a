"""Time-sharded PFB pipelines over ``torch.distributed``.

Counterpart of :mod:`ska_pst_dsp_tpu.parallel.sharded`. The overlap-save
pipeline is parallel over time once each shard has a halo of its
neighbour's samples: the analysis needs the next ``padded_taps`` samples,
the zero-padded analysis the previous ones, the inversion the next
``2 * overlap`` fine-channel samples.

Every function here is SPMD: it runs on every rank of a :class:`Mesh` with
the rank's local shard and returns the rank's local output shard. The
global stream is cut along time into equal contiguous shards in rank order:
rank ``t`` of the time group holds samples ``[t * n_local, (t + 1) *
n_local)``, and its output holds the matching slice of the global output,
as each docstring says. Shards whose spectrum count is a multiple of
``nu`` all run the analysis kernel with ``block0 = 0`` (the derotation ramp
has period ``nu``), so no per-shard state is needed.

What ``shard_map`` and XLA did implicitly is explicit here:

* halos (``jax.lax.ppermute``) are :func:`right_halo` / :func:`left_halo`,
  point-to-point sends to the neighbour (``dist.batch_isend_irecv``), zeros
  at the stream's edge;
* a global trim, pad or re-split of a sharded array
  (``with_sharding_constraint``) is :func:`reshard`, one
  ``dist.all_to_all_single`` with uneven split sizes;
* the zero-padded analysis' group-delay roll over the global time axis is
  a circular right halo: it wraps from the first rank to the last.

Under the gloo backend on a CUDA device (ranks sharing one card: NCCL
refuses two ranks on one device) every payload is copied to host memory
before it is sent and back to the device after it arrives, because gloo's
point-to-point and all-to-all take CPU tensors. That staging is a counted
step of each exchange (``staged_bytes`` in :meth:`Mesh.stats`), not a
fallback: the backend is the process group's, chosen by whoever created
it. Under NCCL (one rank per card) payloads move in device memory.

The compute is the port's kernels: analysis (``analysis_fused``), the
padded fold and channel DFT, the inversion frontend and its epilogue
dispatch. On a CPU device they run their plain versions, as everywhere in
the port.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from ..ops import cfft
from ..ops.analysis import _prep_filter, padded_chan_const, ramp_table, stream
from ..ops.kernels.analysis_fused import analysis_fused
from ..ops.kernels.analysis_padded_fused import padded_fold_fused
from ..ops.kernels.chan_dft_fused import chan_dft_ramp
from ..ops.kernels.synthesis_fused import fused_inversion
from ..ops.synthesis import synthesis_constants

Span = Tuple[int, int]
#: the exchanges a mesh counts
KINDS = ("halo", "reshard", "all_to_all")


class Mesh:
    """One rank's view of a ('chan', 'time') mesh of ``dc x dt`` ranks
    (``dc = 1``: the 1-D time mesh). Rank ``r`` sits at ``(c, t) =
    divmod(r, dt)``, as ``Mesh(devices.reshape(dc, dt))`` in the JAX
    package. ``time_group`` joins the ranks of one ``c`` in order of ``t``,
    ``chan_group`` those of one ``t`` in order of ``c`` (None where the
    process is alone). ``device`` is where the rank's tensors live and
    ``backend`` the process group's (None for one process).

    Each exchange counts its calls, the bytes this rank sent, the bytes
    copied through host memory, and its time (CUDA events on a card, the
    host clock on the CPU); :meth:`stats` reads them, :meth:`reset` sets
    them to 0."""

    def __init__(self, dc: int, dt: int, rank: int, device, backend: Optional[str],
                 time_group=None, chan_group=None):
        self.dc, self.dt, self.world = dc, dt, dc * dt
        self.rank = rank
        self.c, self.t = divmod(rank, dt)
        self.device = torch.device(device)
        self.backend = backend
        self.time_group, self.chan_group = time_group, chan_group
        self.time_ranks = [self.c * dt + t for t in range(dt)]
        self.chan_ranks = [c * dt + self.t for c in range(dc)]
        #: payloads go through host memory (gloo takes CPU tensors)
        self.staged = backend == "gloo" and self.device.type != "cpu"
        self.reset()

    def reset(self) -> None:
        self._counts = {k: {"calls": 0, "bytes": 0, "staged_bytes": 0, "ms": 0.0}
                        for k in KINDS}
        self._events = []

    def stats(self) -> Dict[str, Dict[str, float]]:
        """{kind: {calls, bytes, staged_bytes, ms}} since the last reset."""
        if self._events:
            torch.cuda.synchronize(self.device)
            for kind, start, end in self._events:
                self._counts[kind]["ms"] += start.elapsed_time(end)
            self._events = []
        return {k: dict(v) for k, v in self._counts.items()}

    @contextlib.contextmanager
    def _timed(self, kind: str, sent: int, received: int):
        """Count one exchange of ``sent`` bytes out and ``received`` in, and
        time what runs inside: the staging both ways and the collective."""
        c = self._counts[kind]
        c["calls"] += 1
        c["bytes"] += sent
        if self.staged:
            c["staged_bytes"] += sent + received
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.append((kind, start, end))
        else:
            t0 = time.perf_counter()
            yield
            c["ms"] += (time.perf_counter() - t0) * 1e3

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A payload as the backend takes it: contiguous, complex viewed as
        real pairs, in host memory when staged."""
        t = t.contiguous()
        if t.is_complex():
            t = torch.view_as_real(t)
        return t.cpu() if self.staged else t

    def _landing(self, shape, dtype) -> torch.Tensor:
        """An empty receive buffer for a payload of ``shape``/``dtype``."""
        if dtype.is_complex:
            shape, dtype = (*shape, 2), torch.empty((), dtype=dtype).real.dtype
        return torch.empty(shape, dtype=dtype,
                           device="cpu" if self.staged else self.device)

    def _unwire(self, buf: torch.Tensor, dtype) -> torch.Tensor:
        if dtype.is_complex:
            buf = torch.view_as_complex(buf)
        return buf.to(self.device)

    def _all_to_all(self, kind: str, group, sends: Sequence[Optional[torch.Tensor]],
                    recv_shapes: Sequence[Optional[tuple]], dtype) -> List[Optional[torch.Tensor]]:
        """One ``all_to_all_single`` over ``group``: ``sends[i]`` goes to
        the group's i-th rank and ``recv_shapes[i]`` arrives from it (None:
        nothing, which is what a rank sends itself)."""
        width = 2 if dtype.is_complex else 1
        in_sizes = [0 if s is None else s.numel() * width for s in sends]
        out_elems = [0 if sh is None else math.prod(sh) * width for sh in recv_shapes]
        real = torch.empty((), dtype=dtype).real.dtype if dtype.is_complex else dtype
        item = torch.empty((), dtype=real).element_size()
        on = "cpu" if self.staged else self.device
        with self._timed(kind, sum(in_sizes) * item, sum(out_elems) * item):
            parts = [self._wire(s).reshape(-1) for s in sends if s is not None and s.numel()]
            send = torch.cat(parts) if parts else torch.empty(0, dtype=real, device=on)
            recv = torch.empty(sum(out_elems), dtype=real, device=on)
            dist.all_to_all_single(recv, send, output_split_sizes=out_elems,
                                   input_split_sizes=in_sizes, group=group)
            got, at = [], 0
            for sh, n in zip(recv_shapes, out_elems):
                if sh is None:
                    got.append(None)
                    continue
                piece = recv[at:at + n]
                at += n
                got.append(self._unwire(
                    piece.reshape(*sh, 2) if dtype.is_complex else piece.reshape(sh), dtype))
        return got


def make_mesh(world: Optional[int] = None, *, device=None) -> Mesh:
    """The 1-D time mesh over every rank of the default process group (one
    rank, no process group, where torch.distributed is not initialized).
    ``device`` defaults to ``cuda:(rank % device_count)``; pass ``"cpu"``
    to run on the CPU. ``world``, where given, must be the group's size."""
    if dist.is_available() and dist.is_initialized():
        n, rank, backend, group = (dist.get_world_size(), dist.get_rank(),
                                   dist.get_backend(), dist.group.WORLD)
    else:
        n, rank, backend, group = 1, 0, None, None
    if world is not None and world != n:
        raise ValueError(
            f"a mesh of {world} ranks needs a process group of {world} "
            f"(distributed.initialize or distributed.spawn); this one has {n}"
        )
    return Mesh(1, n, rank, default_device(rank) if device is None else device,
                backend, time_group=group)


def default_device(rank: int) -> torch.device:
    """The card of a rank: ``cuda:(rank % device_count)``; ranks beyond
    the card count share cards."""
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def even_spans(n_local: int, n_ranks: int) -> List[Span]:
    """Global [start, stop) of each rank's equal shard of ``n_local``."""
    return [(r * n_local, (r + 1) * n_local) for r in range(n_ranks)]


def clipped_spans(n_local: int, n_ranks: int, stop: int) -> List[Span]:
    """:func:`even_spans` cut at the global length ``stop``: the shards
    past it shrink, to nothing."""
    return [(min(a, stop), min(b, stop)) for a, b in even_spans(n_local, n_ranks)]


def _neighbour(x: torch.Tensor, n: int, mesh: Mesh, step: int, dim: int,
               circular: bool) -> torch.Tensor:
    """n samples along ``dim`` of rank ``t + step`` of the time group: its
    first n for step = +1, its last n for step = -1; zeros past the edge
    unless ``circular``."""
    dt, t = mesh.dt, mesh.t
    size = x.shape[dim]
    if n > size and (dt > 1 or circular):
        raise ValueError(
            f"a halo of {n} samples exceeds the {size}-sample shard: it "
            "comes from one neighbour"
        )
    src, dst = t + step, t - step
    if circular:
        src, dst = src % dt, dst % dt
    shape = list(x.shape)
    shape[dim] = n
    if src == t:  # circular on one rank: the rank's own samples
        return x.narrow(dim, 0 if step > 0 else size - n, n).clone()
    if not 0 <= src < dt and not 0 <= dst < dt:
        return x.new_zeros(shape)
    send_to, recv_from = 0 <= dst < dt, 0 <= src < dt
    nbytes = math.prod(shape) * x.element_size()
    with mesh._timed("halo", nbytes if send_to else 0, nbytes if recv_from else 0):
        ops, buf = [], None
        if send_to:
            piece = mesh._wire(x.narrow(dim, 0 if step > 0 else size - n, n))
            ops.append(dist.P2POp(dist.isend, piece, mesh.time_ranks[dst], mesh.time_group))
        if recv_from:
            buf = mesh._landing(shape, x.dtype)
            ops.append(dist.P2POp(dist.irecv, buf, mesh.time_ranks[src], mesh.time_group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        out = x.new_zeros(shape) if buf is None else mesh._unwire(buf, x.dtype)
    return out


def right_halo(x: torch.Tensor, n: int, mesh: Mesh, *, dim: int = -1,
               circular: bool = False) -> torch.Tensor:
    """The first n samples along ``dim`` of the next rank of the time group
    (the counterpart of ``_right_halo``, ``sharded.py:51-58``): zeros on the
    last rank, or, with ``circular``, the first rank's samples."""
    return _neighbour(x, n, mesh, +1, dim, circular)


def left_halo(x: torch.Tensor, n: int, mesh: Mesh, *, dim: int = -1) -> torch.Tensor:
    """The last n samples along ``dim`` of the previous rank of the time
    group (``_left_halo``, ``sharded.py:61-66``): zeros on the first rank."""
    return _neighbour(x, n, mesh, -1, dim, False)


def reshard(local: torch.Tensor, have: Sequence[Span], want: Sequence[Span],
            mesh: Mesh, *, dim: int = -1) -> torch.Tensor:
    """Move a tensor sharded along ``dim`` over the time group from the
    global spans ``have`` (rank t of the group holds ``have[t]``) to the
    spans ``want``; return this rank's ``want[t]``, zeros where no rank
    holds the samples (a global pad). The counterpart of a global trim, pad
    or re-split followed by ``with_sharding_constraint``: each rank sends
    every other rank the part of its span that the other wants, in one
    ``all_to_all_single`` with uneven split sizes, and copies its own part
    in place. The collective runs only where some sample changes rank."""
    dt, t = mesh.dt, mesh.t
    if len(have) != dt or len(want) != dt:
        raise ValueError(f"have and want need one span per rank of the {dt}-rank time group")
    dim %= local.ndim
    h0, h1 = have[t]
    if local.shape[dim] != h1 - h0:
        raise ValueError(f"rank {t} holds {local.shape[dim]} samples, its span is {have[t]}")
    w0, w1 = want[t]

    def cut(a: Span, b: Span) -> Span:
        return max(a[0], b[0]), min(a[1], b[1])

    def shape_of(n: int) -> tuple:
        s = list(local.shape)
        s[dim] = n
        return tuple(s)

    out = local.new_zeros(shape_of(w1 - w0))
    lo, hi = cut(have[t], want[t])
    if hi > lo:
        out.narrow(dim, lo - w0, hi - lo).copy_(local.narrow(dim, lo - h0, hi - lo))
    moves = any(cut(have[s], want[d])[1] > cut(have[s], want[d])[0]
                for s in range(dt) for d in range(dt) if s != d)
    if not moves:
        return out
    sends, shapes = [], []
    for d in range(dt):
        lo, hi = cut(have[t], want[d])
        sends.append(local.narrow(dim, lo - h0, hi - lo) if d != t and hi > lo else None)
    for s in range(dt):
        lo, hi = cut(have[s], want[t])
        shapes.append(shape_of(hi - lo) if s != t and hi > lo else None)
    got = mesh._all_to_all("reshard", mesh.time_group, sends, shapes, local.dtype)
    for s, piece in enumerate(got):
        if piece is not None:
            lo = cut(have[s], want[t])[0]
            out.narrow(dim, lo - w0, piece.shape[dim]).copy_(piece)
    return out


def _local(x, mesh: Mesh) -> Tuple[torch.Tensor, bool]:
    """The rank's (n_pol, n_local) complex64 shard on the mesh's device,
    and whether it came as an (re, im) pair."""
    z, pair = stream(x)
    return z.to(mesh.device), pair


#: host constants on a device, keyed by the function that made them, its
#: arguments and the device
_CONSTS: Dict[tuple, Any] = {}


def _key(v):
    if isinstance(v, (np.ndarray, list, torch.Tensor)):
        a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
        return a.shape, a.dtype.str, a.tobytes()
    return v


def device_const(build: Callable, *args, device, **kw):
    """``build(*args, **kw)`` (a numpy array, or a dict of them or None)
    as tensors on ``device``, built once per arguments and device: every
    sharded call of one geometry reuses its tables, as the kernel wrappers
    reuse theirs. The tensors are shared: callers only read them."""
    key = (build, str(torch.device(device)), tuple(_key(a) for a in args),
           tuple((k, _key(kw[k])) for k in sorted(kw)))
    if key not in _CONSTS:
        made = build(*args, **kw)
        _CONSTS[key] = ({k: None if v is None else torch.as_tensor(v, device=device)
                         for k, v in made.items()} if isinstance(made, dict)
                        else torch.as_tensor(made, device=device))
    return _CONSTS[key]


def _check_shard(n_local: int, step: int, nu: int) -> None:
    if n_local <= 0 or n_local % (step * nu):
        raise ValueError(f"shard size {n_local} must be a multiple of step*nu = {step * nu}")


def analysis_tm(z: torch.Tensor, filt, block: int, os_factor: Rational,
                mesh: Mesh) -> torch.Tensor:
    """The sharded analysis on a (batch, n_local) shard, time-major out:
    (batch, n_local // step, block). The halo is the next rank's first
    ``padded_taps`` samples."""
    step = geometry.analysis_step(block, os_factor)
    _check_shard(z.shape[-1], step, os_factor.nu)
    f2d = device_const(_prep_filter, filt, block, device=z.device)
    ramp = device_const(ramp_table, block, step, device=z.device)
    halo = right_halo(z, f2d.numel(), mesh)
    return analysis_fused(torch.cat([z, halo], dim=-1), f2d, ramp, step)


def sharded_polyphase_analysis(x, filt, block: int, os_factor, mesh: Mesh):
    """Time-sharded single-stage analysis PFB.

    x: the rank's (n_pol, n_local) shard of the global (n_pol, n_dat)
    stream (complex, or an (re, im) pair), n_local a multiple of step*nu.
    Returns the rank's (n_pol, block, n_local // step) spectra, global
    spectra ``[t * n_local // step, (t + 1) * n_local // step)`` of the
    (n_pol, block, n_dat // step) output; the spectra past
    ``geometry.analysis_nblocks`` (on the last rank) come from the zero
    halo, as in the JAX package: callers slice. Same kind as the input."""
    os_factor = Rational.coerce(os_factor)
    z, pair = _local(x, mesh)
    return cfft.same_kind(analysis_tm(z, filt, block, os_factor, mesh).transpose(1, 2), pair)


def padded_halo_blocks(fl: int, step: int, nu: int) -> int:
    """Spectra of filter history the padded analysis recomputes per shard:
    at least ``fl`` samples, in whole spectra, a multiple of ``nu`` so the
    kept spectra keep the ramp schedule (``sharded.py:160-164``)."""
    blocks = -(-fl // step)
    return blocks + (-blocks) % nu


def roll_time(spec: torch.Tensor, delay: int, mesh: Mesh, *, dim: int = 1) -> torch.Tensor:
    """The global ``roll(spec, -delay)`` along the sharded ``dim``: the
    rank keeps its spectra from ``delay`` on and appends the next rank's
    first ``delay`` (the first rank's on the last rank: the roll wraps)."""
    n_total = spec.shape[dim] * mesh.dt
    delay %= n_total
    if not delay:
        return spec
    head = right_halo(spec, delay, mesh, dim=dim, circular=True)
    return torch.cat([spec.narrow(dim, delay, spec.shape[dim] - delay), head], dim=dim)


def analysis_padded_tm(z: torch.Tensor, filt, block: int, os_factor: Rational,
                       mesh: Mesh) -> torch.Tensor:
    """The sharded zero-padded analysis on a (batch, n_local) shard without
    the group-delay roll, time-major out: (batch, n_local // step, block).
    The halo is the previous rank's last filter history; the first rank's
    is zeros, the true stream start."""
    step = geometry.analysis_step(block, os_factor)
    _check_shard(z.shape[-1], step, os_factor.nu)
    f2d_rev = device_const(_prep_filter, filt, block, reverse=True, device=z.device)
    const = device_const(padded_chan_const, block, step, device=z.device)
    hb = padded_halo_blocks(f2d_rev.numel(), step, os_factor.nu)
    halo = left_halo(z, hb * step, mesh)
    g = padded_fold_fused(torch.cat([halo, z], dim=-1), f2d_rev, step)
    # hb is a multiple of nu: the kept spectra start on ramp row 0
    return chan_dft_ramp(g, const, 0, 0)[:, hb:]


def sharded_polyphase_analysis_padded(x, filt, block: int, os_factor, mesh: Mesh, *,
                                      apply_delay: bool = True):
    """Time-sharded zero-padded (SKA-Mid) analysis PFB.

    x: the rank's (n_pol, n_local) shard, n_local a multiple of step*nu.
    Returns the rank's (n_pol, block, n_local // step) slice of the global
    (n_pol, block, n_dat // step) output, advanced by the group delay over
    the global stream (the roll wraps from the first rank to the last), or
    not with ``apply_delay=False``. Same kind as the input."""
    os_factor = Rational.coerce(os_factor)
    z, pair = _local(x, mesh)
    spec = analysis_padded_tm(z, filt, block, os_factor, mesh)
    if apply_delay:
        delay = geometry.padded_sample_delay_shift(np.asarray(filt).size, block, os_factor)
        spec = roll_time(spec, delay, mesh)
    return cfft.same_kind(spec.transpose(1, 2), pair)


def inversion_consts(n_chan: int, L: int, os_factor, input_overlap: int, device, **kw
                     ) -> Dict[str, Optional[torch.Tensor]]:
    """:func:`..ops.synthesis.synthesis_constants` on ``device`` (built
    once per geometry: :func:`device_const`)."""
    return device_const(synthesis_constants, n_chan, L, Rational.coerce(os_factor),
                        input_overlap, device=device, **kw)


def trim_local(out: torch.Tensor, start: int, valid: int) -> torch.Tensor:
    """The part of a rank's output, at global offset ``start`` along its
    last axis, that lies before the global length ``valid``."""
    return out[..., :max(0, min(out.shape[-1], valid - start))]


def synthesis_tm(x_tc: torch.Tensor, c: Dict[str, Optional[torch.Tensor]],
                 geom: geometry.SynthesisGeometry, mesh: Mesh, *, spans_nyquist: bool,
                 valid: Optional[int] = None) -> torch.Tensor:
    """The sharded inversion of a time-major (batch, n_local, n_chan)
    shard, n_local a multiple of input_keep: the next rank's first
    2*overlap samples as halo, then the frontend kernel and the epilogue
    dispatch. Returns (batch, 1, n_local // keep * output_keep) cut at the
    global output length ``valid`` (default the one-shot count of the whole
    stream), so the last rank's zero-halo block is dropped."""
    n_local = x_tc.shape[1]
    keep = geom.input_keep
    if n_local <= 0 or n_local % keep:
        raise ValueError(f"shard size {n_local} must be a multiple of input_keep={keep}")
    halo = right_halo(x_tc, 2 * geom.input_overlap, mesh, dim=1)
    out = fused_inversion(torch.cat([x_tc, halo], dim=1), c["t_taper"], c["dr"], c["perm"],
                          c["elem"], geom, spans_nyquist=spans_nyquist)
    if valid is None:
        valid = geom.n_blocks(n_local * mesh.dt) * geom.output_keep
    return trim_local(out, mesh.t * out.shape[-1], valid)


def sharded_polyphase_synthesis(
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
    combine: int = 1,
    monotonic: bool = False,
):
    """Time-sharded Golden inversion.

    x: the rank's (n_pol, n_chan, n_local) shard of the global
    (n_pol, n_chan, n_dat) fine channels, n_local a multiple of
    input_keep. Returns the rank's (n_pol, 1, n_local // keep *
    output_keep) slice of the global (n_pol, 1, n_blocks * output_keep)
    inversion, which equals the one-shot kernel's; the last rank's is
    shorter by the blocks the one-shot count drops. ``combine``,
    ``monotonic`` and ``spans_nyquist`` as in the JAX package (the
    permutation is local: channels are not sharded)."""
    os_factor = Rational.coerce(os_factor)
    z, pair = cfft.as_complex(x)
    z = z.to(mesh.device)
    n_chan = z.shape[1]
    L = input_fft_length
    if input_overlap is None:
        input_overlap = L // 8
    geom = geometry.SynthesisGeometry(n_chan, L, input_overlap, os_factor)
    c = inversion_consts(n_chan, L, os_factor, input_overlap, z.device,
                         spans_nyquist=spans_nyquist, deripple_coeff=deripple_coeff,
                         temporal_taper=temporal_taper, spectral_taper=spectral_taper,
                         combine=combine, monotonic=monotonic)
    out = synthesis_tm(z.transpose(1, 2), c, geom, mesh, spans_nyquist=spans_nyquist)
    return cfft.same_kind(out, pair)


def _round_trip_synthesis(chan_tm, t_valid, filt, n_chan, os_factor, L, ov, mesh,
                          temporal_taper, deripple, invert=None, blocks_multiple=1):
    """Trim the analysis output to whole inversion blocks per time shard
    (a multiple of ``blocks_multiple`` of them), re-split it evenly over
    the time group and invert it with ``invert`` (default
    :func:`synthesis_tm`; ``sharded.py:300-313``, ``corner_turn.py:176-188``)."""
    quantum = (L - 2 * ov) * blocks_multiple
    t_shard = (t_valid // (mesh.dt * quantum)) * quantum
    chan_tm = reshard(chan_tm, even_spans(chan_tm.shape[1], mesh.dt),
                      even_spans(t_shard, mesh.dt), mesh, dim=1)
    geom = geometry.SynthesisGeometry(n_chan, L, ov, os_factor)
    c = inversion_consts(n_chan, L, os_factor, ov, chan_tm.device,
                         deripple_coeff=filt if deripple else None,
                         temporal_taper=temporal_taper)
    return (invert or synthesis_tm)(chan_tm, c, geom, mesh, spans_nyquist=True)


def sharded_round_trip(x, filt, n_chan: int, os_factor, input_fft_length: int,
                       input_overlap: int, mesh: Mesh, *, temporal_taper: str = "tukey",
                       deripple: bool = True):
    """Time-sharded analysis, then time-sharded Golden inversion.

    x: the rank's (n_pol, n_local) shard, n_local a multiple of step*nu.
    The fine channels are cut to whole inversion blocks per rank and
    re-split (:func:`reshard`). Returns the rank's slice of the global
    (n_pol, 1, n_out) inversion, which equals the one-shot chain's on the
    same stream, in rank order."""
    os_factor = Rational.coerce(os_factor)
    z, pair = _local(x, mesh)
    chan = analysis_tm(z, filt, n_chan, os_factor, mesh)
    t_valid = geometry.analysis_nblocks(z.shape[-1] * mesh.dt, np.asarray(filt).size,
                                        n_chan, os_factor)
    out = _round_trip_synthesis(chan, t_valid, filt, n_chan, os_factor, input_fft_length,
                                input_overlap, mesh, temporal_taper, deripple)
    return cfft.same_kind(out, pair)


def sharded_round_trip_padded(x, filt, n_chan: int, os_factor, input_fft_length: int,
                              input_overlap: int, mesh: Mesh, *,
                              temporal_taper: str = "tukey", deripple: bool = True):
    """Time-sharded zero-padded (SKA-Mid) analysis, then time-sharded
    Golden inversion: :func:`sharded_round_trip` with the padded analysis
    and its group-delay roll."""
    os_factor = Rational.coerce(os_factor)
    z, pair = _local(x, mesh)
    spec = analysis_padded_tm(z, filt, n_chan, os_factor, mesh)
    delay = geometry.padded_sample_delay_shift(np.asarray(filt).size, n_chan, os_factor)
    spec = roll_time(spec, delay, mesh)
    t_valid = z.shape[-1] * mesh.dt // geometry.analysis_step(n_chan, os_factor)
    out = _round_trip_synthesis(spec, t_valid, filt, n_chan, os_factor, input_fft_length,
                                input_overlap, mesh, temporal_taper, deripple)
    return cfft.same_kind(out, pair)
