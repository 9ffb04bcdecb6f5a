"""Streaming channelizer / de-channelizer layer.

Counterpart of :mod:`ska_pst_dsp_tpu.models.streaming` (FilterBank.m:65-126,
InverseFilterBank.m:92-150): arbitrarily long streams are processed in
blocks, with unconsumed samples carried between calls so that streamed
output is *identical* to one-shot output. The state is an explicit
dataclass (buffer + absolute counters) returned alongside each output.

The carry is the JAX module's (streaming.py:14-29):

* analysis output is truncated to a multiple of ``chunk_spectra`` spectra,
  itself a multiple of os_factor.nu, so the derotation schedules restart
  cleanly (FilterBank.m:93-104);
* consumed input = emitted_spectra * step; the remainder (holding the
  filter history) is buffered (FilterBank.m:119-126);
* the zero-padded (SKA-Mid) analysis carries a filter length of history,
  so its streamed output equals its one-shot output (the reference re-pads
  at every block boundary);
* the LowCBF first-call zero pad counts in the consumed samples;
* the inversion consumes n_blocks*input_keep fine-channel samples,
  buffering the 2*overlap overlap-save history (InverseFilterBank.m:104-135);
  ``sample_offset`` applies once;
* ``chunk_spectra`` / ``chunk_blocks`` adapt to the first block.

How the port runs it: each stage is an ``nn.Module`` whose filter, ramp and
inversion constants are buffers on its device (default the card), built
once per geometry; the carried buffer and the chunks are tensors there.
The analyses join the carried samples and the new block with ``torch.cat``
(:func:`carry`); the inversion hands both to its kernel as they lie where
the kernel reads two inputs (the fused inversion's geometries, and the
plain versions), and joins only where it consumes less than it holds. A
call runs all the whole chunks its input holds
in one launch of each kernel (the JAX classes launch once per chunk): every
spectrum and every inversion block is computed on its own, so the output
and the carried state are the same. The analysis runs the fused kernels
(:func:`..ops.kernels.analysis_fused.analysis_fused`; the padded fold then
the channel DFT at ``block0`` = the chunk's first raw spectrum and no
delay roll; LowCBF on the analysis kernel, :mod:`..ops.lowcbf`) and the
inversion :func:`..ops.kernels.synthesis_fused.fused_inversion` on a
time-major view of the chunk. ``plain=True`` runs the kernels' plain
versions on the same device instead: the reference chain.

A ``FilterBank`` hands back (n_pol, channels, n): a view of the kernel's
time-major store, or, built with ``channel_major`` (the cascades' stages,
``models/two_stage.py``), the analysis's channel-major store itself,
contiguous, where the kernel has that store for the geometry (block 256
on the generic fold; the plain versions at any).

Optional input/output integer rounding with rms scaling reproduces the
reference's quantization-study hooks (FilterBank.m:75-113, sgcht
rndInput/rmsInput/rndOutput/rmsOutput); output is rounded per chunk of
``chunk_spectra`` spectra, as in the JAX module.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.profiling import spanned
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from ..ops import lowcbf
from ..ops.analysis import (
    _prep_filter, analysis_plain, chan_dft_core, padded_chan_const, padded_fold, ramp_table,
)
from ..ops.kernels.analysis_fused import analysis_fused
from ..ops.kernels.analysis_fused import takes as analysis_takes
from ..ops.kernels.analysis_padded_fused import padded_fold_fused
from ..ops.kernels.chan_dft_fused import chan_dft_ramp
from ..ops.kernels.inversion_fused import takes as inversion_takes
from ..ops.kernels.synthesis_fused import fused_inversion
from ..ops.synthesis import inversion_core, synthesis_constants

PLAIN, PADDED, LOWCBF = ("polyphase_analysis", "polyphase_analysis_padded",
                         "polyphase_analysis_lowcbf")


def _round_rms(x: torch.Tensor, rms: float, stats: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Round to integers, optionally pre-scaling to a target rms
    (FilterBank.m:75-83), on x's device: the population variance of both
    quadratures (``np.var``) of ``stats`` (default x: the same values,
    in the order whose sum sets the scale) and round half to even
    (``np.round``)."""
    scale = 1.0
    if rms > 0:
        s = x if stats is None else stats
        std = torch.sqrt(torch.var(torch.stack([s.real, s.imag]), correction=0) * 2.0)
        scale = rms / std
    return torch.complex(torch.round(x.real * scale), torch.round(x.imag * scale))


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A complex tensor or array as complex64 on ``device``."""
    return torch.as_tensor(x, device=device).to(torch.complex64)


@spanned("carry")
def carry(held: torch.Tensor, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The carried samples ``held`` and the new block ``x`` joined along
    ``dim`` (the ``carry`` span), the bytes it writes counted in
    ``carry.bytes``."""
    out = torch.cat([held, x], dim=dim)
    carry.bytes += out.numel() * out.element_size()
    return out


#: bytes the streaming stages' carries have written since the process began
carry.bytes = 0


@dataclasses.dataclass
class FilterBankState:
    """Carry between FilterBank.execute calls.

    ``buffer`` (n_pol, nbuf) holds input samples from absolute position
    ``base`` onward that have not been fully consumed; ``emitted`` counts
    output spectra already produced (in the delayed timeline for the padded
    analysis)."""

    buffer: Optional[torch.Tensor] = None
    base: int = 0
    emitted: int = 0


class FilterBank(nn.Module):
    """Streaming analysis filterbank (the reference's Channelizer role)."""

    def __init__(self, config, *, rnd_input=False, rms_input=0.0, rnd_output=False,
                 rms_output=0.0, chunk_spectra=None, device="cuda", plain=False,
                 channel_major=False):
        super().__init__()
        self.config = config
        self.analysis_function = config.analysis_function
        self.filt_coeff = np.asarray(config.load_fir_filter_coeff())
        self.n_chan = config.channels
        self.os_factor = Rational.coerce(config.os_factor)
        self.step = geometry.analysis_step(self.n_chan, self.os_factor)
        self.fl = geometry.padded_filter_length(self.filt_coeff.size, self.n_chan)
        self.rnd_input = rnd_input or rms_input > 0
        self.rms_input = rms_input
        self.rnd_output = rnd_output or rms_output > 0
        self.rms_output = rms_output
        #: spectra per chunk: the output comes in whole chunks
        self.chunk_spectra = chunk_spectra
        self.device = torch.device(device)
        self.plain = plain
        self._analyse = analysis_plain if plain else analysis_fused
        name = self.analysis_function
        rows = None
        if name == PLAIN:
            f2d, ramp = _prep_filter(self.filt_coeff, self.n_chan), ramp_table(self.n_chan, self.step)
        elif name == PADDED:
            self.delay = geometry.padded_sample_delay_shift(
                self.filt_coeff.size, self.n_chan, self.os_factor)
            f2d = _prep_filter(self.filt_coeff, self.n_chan, reverse=True)
            ramp = padded_chan_const(self.n_chan, self.step)
        elif name == LOWCBF:
            f2d, ramp, rows = lowcbf.lowcbf_filter(self.filt_coeff), lowcbf.lowcbf_ramp(), \
                lowcbf.kept_bins()
        else:
            raise ValueError(f"unknown analysis function {name!r}")
        #: the analysis stores channel-major (the padded analysis never):
        #: on the card where its kernel has that store for the geometry
        self.channel_major = channel_major and name != PADDED and (
            plain or self.device.type == "cpu"
            or analysis_takes(f2d.shape[1], self.step if name == PLAIN else lowcbf.STEP,
                              f2d.shape[0], ramp.shape[0], channel_major=True))
        if self.channel_major and rows is None:
            rows = np.arange(self.n_chan)
        #: the fold's filter (reversed for the padded analysis), the per-bin
        #: table (the derotation ramp, the padded channel-DFT constant or
        #: the LowCBF quarter turns) and the bins stored (LowCBF's kept
        #: bins; every bin of a channel-major store; None: every bin)
        self.register_buffer("f2d", torch.as_tensor(f2d, device=self.device))
        self.register_buffer("ramp", torch.as_tensor(ramp, device=self.device))
        self.register_buffer("rows", None if rows is None
                             else torch.as_tensor(rows.astype(np.int32), device=self.device))

    def init_state(self) -> FilterBankState:
        return FilterBankState()

    @property
    def n_chan_out(self) -> int:
        if self.analysis_function == LOWCBF:
            return self.config.kept_channels or lowcbf.KEPT
        return self.n_chan

    @spanned("filterbank")
    def execute(self, state: FilterBankState, x) -> Tuple[FilterBankState, torch.Tensor]:
        """Process one block of (n_pol, [1,] n) samples: returns (new_state,
        (n_pol, n_chan_out, n_out)) on the module's device: the channel-major
        store itself where the stage has one, else a view of the time-major
        spectra."""
        x = as_tensor(x, self.device)
        if x.ndim == 3:
            x = x[:, 0, :]
        if self.rnd_input:
            x = _round_rms(x, self.rms_input)
        if state.buffer is not None and state.buffer.shape[-1] > 0:
            x = carry(state.buffer, x, -1)
        n_dat = x.shape[-1]
        nu = self.os_factor.nu
        name = self.analysis_function
        if self.chunk_spectra is None:
            # adapt once to the caller's first block size
            if name == LOWCBF:
                usable = (n_dat + lowcbf.FIRST_CALL_PAD - lowcbf.NFILT) // lowcbf.STEP
            elif name == PADDED:
                usable = n_dat // self.step
            else:
                usable = (n_dat - self.fl) // self.step
            self.chunk_spectra = max(nu, (usable // nu) * nu)
        step_fn = {PLAIN: self._execute_plain, PADDED: self._execute_padded,
                   LOWCBF: self._execute_lowcbf}[name]
        state, out, rest = step_fn(state, x)
        cm = self.channel_major
        if out is None:
            n_pol, c = x.shape[0], self.n_chan_out
            out = x.new_zeros((n_pol, c, 0) if cm else (n_pol, 0, c))
        elif self.rnd_output:
            # a channel-major chunk's scale from its spectra taken time-major
            t = 2 if cm else 1
            out = torch.cat([_round_rms(c, self.rms_output, c.transpose(1, 2) if cm else None)
                             for c in out.split(self.chunk_spectra, dim=t)], dim=t)
        return dataclasses.replace(state, buffer=rest), out if cm else out.transpose(1, 2)

    def _whole(self, spectra: int) -> int:
        """The spectra of the whole chunks among ``spectra``."""
        return max(spectra, 0) // self.chunk_spectra * self.chunk_spectra

    # -- single-stage (Bunton) ------------------------------------------
    def _execute_plain(self, state, x):
        n = self._whole((x.shape[-1] - self.fl) // self.step)
        if n == 0:
            return state, None, x
        out = self._analyse(x[:, :self.fl + n * self.step], self.f2d, self.ramp, self.step,
                            state.emitted, rows=self.rows)
        consumed = n * self.step
        return (FilterBankState(base=state.base + consumed, emitted=state.emitted + n),
                out, x[:, consumed:])

    # -- zero-padded (Gunaratne / SKA-Mid) ------------------------------
    def _execute_padded(self, state, x):
        step, base = self.step, state.base
        raw0 = base // step
        need = state.emitted + self.delay  # next absolute raw spectrum to emit
        n = self._whole(raw0 + x.shape[-1] // step - need)
        if n == 0:
            return state, None, x
        chunk = x[:, :(need + n - raw0) * step]
        if self.plain:
            raw = chan_dft_core(padded_fold(chunk, self.f2d, step), self.ramp, raw0)
        else:
            raw = chan_dft_ramp(padded_fold_fused(chunk, self.f2d, step), self.ramp, raw0)
        out = raw[:, need - raw0:need - raw0 + n]
        emitted = state.emitted + n
        # carry the filter length of history before raw spectrum emitted + delay
        new_base = max(0, (emitted + self.delay) * step - self.fl)
        new_base -= new_base % step
        new_base = min(new_base, base + x.shape[-1])
        return FilterBankState(base=new_base, emitted=emitted), out, x[:, new_base - base:]

    # -- LowCBF firmware model ------------------------------------------
    def _execute_lowcbf(self, state, x):
        first = state.base == 0 and state.emitted == 0
        pad = lowcbf.FIRST_CALL_PAD if first else 0
        n = self._whole((x.shape[-1] + pad - lowcbf.NFILT) // lowcbf.STEP)
        if n == 0:
            return state, None, x
        out = lowcbf.lowcbf_core(x[:, :lowcbf.NFILT + n * lowcbf.STEP - pad], self.f2d,
                                 self.ramp, self.rows, first, self._analyse, self.channel_major)
        consumed = n * lowcbf.STEP - pad
        return (FilterBankState(base=state.base + consumed, emitted=state.emitted + n),
                out, x[:, consumed:])


@dataclasses.dataclass
class InverseFilterBankState:
    buffer: Optional[torch.Tensor] = None  # (n_pol, n_chan, nbuf)
    consumed: int = 0                      # absolute fine-channel samples consumed


class InverseFilterBank(nn.Module):
    """Streaming PFB inversion (DeChannelizer): the Golden inversion with
    the reference's buffered-carry semantics."""

    def __init__(self, config, *, critical: bool = False, combine: int = 1,
                 sample_offset: int = 0, spectral_taper="no_window",
                 deripple: Optional[bool] = None, chunk_blocks: Optional[int] = None,
                 monotonic: bool = False, device="cuda", plain: bool = False,
                 overlap: Optional[int] = None):
        super().__init__()
        self.config = config
        self.filt_coeff = np.asarray(config.load_fir_filter_coeff())
        self.n_fft = config.input_fft_length
        self.n_chan = config.channels
        self.os_factor = Rational.coerce(config.os_factor)
        #: the input overlap discarded a side (default the configuration's,
        #: which the temporal taper spans whatever this is)
        self.overlap = config.input_overlap if overlap is None else overlap
        self.deripple = bool(config.deripple) if deripple is None else deripple
        self.temporal_taper = config.temporal_taper
        self.spectral_taper = spectral_taper
        #: the spectral filter on the inversion's output spectrum
        #: (:meth:`set_spectral_filter`)
        self.spectral_filter = None
        self.critical = critical
        self.combine = combine
        #: fine channels arrive in monotonic (fftshifted) frequency order
        #: (chomped LowCBF cascades): the DSB combine reordering is skipped
        self.monotonic = monotonic
        self.sample_offset = sample_offset
        self._offset_pending = sample_offset
        #: overlap-save blocks per chunk: the output comes in whole chunks
        self.chunk_blocks = chunk_blocks
        self.device = torch.device(device)
        self.plain = plain
        #: channel count the constant buffers were built for
        self._n_chan_built = None
        self.geom = None
        for name in ("t_taper", "dr", "perm", "elem"):
            self.register_buffer(name, None)

    def frequency_taper(self, name) -> "InverseFilterBank":
        """Install a spectral taper (InverseFilterBank.m:48-61)."""
        self.spectral_taper = name
        self._n_chan_built = None
        return self

    def set_spectral_filter(self, spectral_filter) -> "InverseFilterBank":
        """Install a spectral filter on the inversion's output spectrum
        (``synthesis_constants``): (N,), or (rows, N), the row ``s % rows``
        of stream s (a coherent-dedispersion chirp a coarse channel); None
        removes it."""
        self.spectral_filter = spectral_filter
        self._n_chan_built = None
        return self

    def init_state(self) -> InverseFilterBankState:
        self._offset_pending = self.sample_offset
        return InverseFilterBankState()

    def _constants(self, n_chan: int) -> None:
        """The inversion's constants for ``n_chan`` input channels, as
        buffers; built once per channel count."""
        if self._n_chan_built == n_chan:
            return
        c = synthesis_constants(
            n_chan, self.n_fft, self.os_factor, self.overlap,
            spans_nyquist=not self.critical,
            deripple_coeff=self.filt_coeff if self.deripple else None,
            temporal_taper=self.temporal_taper, spectral_taper=self.spectral_taper,
            combine=self.combine, monotonic=self.monotonic,
            spectral_filter=self.spectral_filter, taper_overlap=self.config.input_overlap,
        )
        for name in ("t_taper", "dr", "perm", "elem"):
            setattr(self, name, None if c[name] is None
                    else torch.as_tensor(c[name], device=self.device))
        self.geom = geometry.SynthesisGeometry(n_chan, self.n_fft, self.overlap,
                                               self.os_factor)
        self._n_chan_built = n_chan

    def _reads_split(self, n_chan: int) -> bool:
        """Whether the inversion reads the held samples and the new block
        where they lie, as two inputs: the plain versions (which join them
        themselves) and the fused kernel (:func:`..ops.kernels.inversion_fused.takes`
        the geometry); the frontend kernel and its epilogue read one."""
        g = self.geom
        return self.plain or inversion_takes(g.input_fft_length, n_chan,
                                             g.output_fft_length, g.output_overlap)

    @spanned("inverse_filterbank")
    def execute(self, state: InverseFilterBankState, x
                ) -> Tuple[InverseFilterBankState, torch.Tensor]:
        """Invert one block of (n_pol, n_chan, n) fine channels: returns
        (new_state, (n_pol, 1, n_out)) on the module's device.

        The stage's stream is the held samples followed by x. Where the
        inversion reads two inputs (:meth:`_reads_split`) it gets both as
        they lie, and the samples held for the next call are a view of x
        where the consumed ones cover the held ones (x must then stay as it
        is until that call, as after a first call), else the unconsumed held
        samples joined with x by :func:`carry`; the other route joins the
        held samples and x by :func:`carry` first. A call that consumes no
        whole chunk holds them all, joined by :func:`carry`."""
        x = as_tensor(x, self.device)
        held = state.buffer
        h = 0 if held is None else held.shape[-1]
        n_pol, n_chan, n_new = x.shape
        n_dat = h + n_new
        offset = self._offset_pending
        keep = self.n_fft - 2 * self.overlap
        if self.chunk_blocks is None:
            self.chunk_blocks = max(1, (n_dat - offset - 2 * self.overlap) // keep)
        B = self.chunk_blocks
        n_blocks = max(0, (n_dat - offset - 2 * self.overlap) // keep) // B * B
        if n_blocks == 0:
            return (InverseFilterBankState(buffer=carry(held, x, 2) if h else x,
                                           consumed=state.consumed),
                    x.new_zeros((n_pol, 1, 0)))
        self._constants(n_chan)
        if h and not self._reads_split(n_chan):
            x, h = carry(held, x, 2), 0
        consumed = offset + n_blocks * keep
        end = consumed + 2 * self.overlap
        # the stream's samples [offset, end): those of held, then those of x
        lead = held[:, :, offset:end] if offset < h else None
        chunk = x[:, :, max(offset - h, 0):max(end - h, 0)]
        invert = inversion_core if self.plain else fused_inversion
        out = invert(chunk.transpose(1, 2), self.t_taper, self.dr, self.perm, self.elem,
                     self.geom, spans_nyquist=not self.critical,
                     held=None if lead is None else lead.transpose(1, 2))
        self._offset_pending = 0
        rest = x[:, :, consumed - h:] if consumed >= h else carry(held[:, :, consumed:], x, 2)
        return (InverseFilterBankState(buffer=rest, consumed=state.consumed + consumed), out)


class StatefulPipeline:
    """Chains streaming stages with held state, mirroring the reference's
    ``[obj, x] = execute(obj, x)`` block loop."""

    def __init__(self, *stages):
        self.stages = list(stages)
        self.states = [s.init_state() for s in stages]

    def execute(self, x):
        for i, stage in enumerate(self.stages):
            self.states[i], x = stage.execute(self.states[i], x)
        return x
