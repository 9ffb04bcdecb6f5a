"""Two-stage filterbank cascades.

Counterpart of :mod:`ska_pst_dsp_tpu.models.two_stage`
(TwoStageFilterBank.m:1-118, TwoStageInverseFilterBank.m:1-159): a
first-stage coarse channelizer feeding per-coarse-channel second-stage
channelizers, and the inverse cascade. As in the JAX package all coarse
channels run through one batched stage-2 call: they ride the batch axis of
the analysis kernel, and the inverse cascade's slabs the batch axis of the
inversion.

Both stages store their spectra channel-major (``FilterBank``'s
``channel_major``; LowCBF's 216 kept bins alone), which is what the next
step reads: stage 1's (n_pol, nch1, T) is one stream per coarse channel
as it stands, and stage 2's (n_pol*nch1, nch2, T2) is the output's
(n_pol, nch1*nch2, T2), so both corner turns are views. A stage whose
geometry has no channel-major kernel on the card stores time-major, and
its corner turn copies. The cascade's own reshapes (those corner turns,
the chomp and the layout of the output, the inverse's slabs) are the
``corner_turn`` span; the bytes of those that copy (the critical chomps,
and the corner turns of a time-major stage) are counted in
``corner_turn.bytes``.

The inverse cascade can dedisperse each coarse channel coherently inside
its inversion, as an SKA-Low PST node does with LowCBF's PST beam
(``dedispersion``, an :class:`..ops.dedispersion.Dedispersion`): one chirp
a coarse channel at its own centre frequency, the inversion's ``(coarse
channels, N)`` spectral filter, built once per channel count (the
``chirp_table`` span). The inversion of monotonic (LowCBF) fine channels
holds the coarse channel's centre at bin N/2 of its spectrum and its lowest
fine channel's centre at bin 0 (its output is the coarse channel shifted by
half its band), so the chirp rows are fftshifted to that order;
dedispersion takes the oversampled slab only. The chirp of a kept sample
reads the samples within its reach on either side, and those have to be
untapered: the inversion then discards the temporal taper's overlap plus
the band's widest reach a side (dspsr's discard of taper plus the
response's impulse), so its hop shortens. A DM whose discard leaves
nothing of a frame to keep is refused at ``init_state``: it needs a longer
inversion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.profiling import span, spanned
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from ..ops.dedispersion import Dedispersion
from ..ops.kernels.inversion_fused import frame_lengths
from .streaming import (
    LOWCBF, FilterBank, FilterBankState, InverseFilterBank, InverseFilterBankState, as_tensor,
)


def corner_turn(src: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out``, a reshape of ``src`` by the cascade's own code; where it
    is a copy (not a view of ``src``'s storage), its bytes are counted in
    ``corner_turn.bytes``."""
    if out.untyped_storage().data_ptr() != src.untyped_storage().data_ptr():
        corner_turn.bytes += out.numel() * out.element_size()
    return out


#: bytes the cascades' corner turns, chomps and slab reshapes have copied
#: since the process began
corner_turn.bytes = 0


@dataclasses.dataclass
class TwoStageFilterBankState:
    stage1: FilterBankState
    stage2: FilterBankState  # one batched state for all coarse channels


class TwoStageFilterBank(nn.Module):
    """Stage-1 coarse channelizer + batched stage-2 fine channelizers.

    critical: keep only the critically sampled subset of stage-2 channels,
    chomping the oversampled middle (TwoStageFilterBank.m:81-105).
    single: process/output only coarse channel 0 (:87-89).
    device, plain: as :class:`.streaming.FilterBank`'s, for both stages.
    """

    def __init__(self, config, config2=None, *, critical=False, single=False,
                 device="cuda", plain=False, **fb_kwargs):
        super().__init__()
        self.config1 = config
        self.config2 = config2 if config2 is not None else config
        self.device, self.plain = torch.device(device), plain
        self.stage1 = FilterBank(config, device=device, plain=plain, channel_major=True,
                                 **fb_kwargs)
        self.stage2 = FilterBank(self.config2, device=device, plain=plain, channel_major=True,
                                 **fb_kwargs)
        self.critical = critical
        self.single = single

    @property
    def stage2_monotonic(self) -> bool:
        """Stage-2 channels in fftshifted (monotonic-frequency) order: true
        for the LowCBF firmware model (ops/lowcbf.py)."""
        return self.config2.analysis_function == LOWCBF

    def set_stage2_config(self, config2):
        self.config2 = config2
        self.stage2 = FilterBank(config2, device=self.device, plain=self.plain,
                                 channel_major=True)

    def init_state(self) -> TwoStageFilterBankState:
        return TwoStageFilterBankState(self.stage1.init_state(), self.stage2.init_state())

    @spanned("two_stage.filterbank")
    def execute(self, state: TwoStageFilterBankState, x
                ) -> Tuple[TwoStageFilterBankState, torch.Tensor]:
        """(n_pol, [1,] n) samples -> (new_state, (n_pol, nch1*nch2, T2))."""
        s1, out1 = self.stage1.execute(state.stage1, x)  # (n_pol, nch1, T)

        nch1 = 1 if self.single else out1.shape[1]
        os = Rational.coerce(self.stage1.os_factor)
        # channels the stage-2 kernel actually emits: the LowCBF firmware
        # model already outputs only its critically-sampled subset
        # (216 = 256*27/32, polyphase_analysis_lowcbf.m:16,43), in which
        # case the critical chomp below is a no-op
        nch2_orig = self.stage2.n_chan_out
        nch2 = os.normalize(self.stage2.n_chan) if self.critical else nch2_orig
        offset = nch2_orig - nch2

        # the corner turn: one stream per coarse channel, (n_pol*nch1, T)
        n_pol = out1.shape[0]
        with span("corner_turn"):
            streams = corner_turn(out1, out1[:, :nch1, :].reshape(n_pol * nch1, out1.shape[2]))
        s2, out2 = self.stage2.execute(state.stage2, streams)
        t2 = out2.shape[2]
        with span("corner_turn"):
            out2 = corner_turn(out2, out2.reshape(n_pol, nch1, nch2_orig, t2))
            if self.critical and offset > 0:
                if self.stage2_monotonic:
                    # LowCBF stage 2 emits its KEPT channels fftshifted (DC at
                    # the middle): the oversampling-redundant channels are the
                    # band EDGES, offset/2 each end. The reference's generic
                    # middle chomp below assumes DC-first order
                    # (TwoStageFilterBank.m:106-107 notes the fftshifted
                    # variant, commented out).
                    out2 = out2[:, :, offset // 2: offset // 2 + nch2, :]
                else:
                    # chomp oversampled middle channels; stage-2 channel 0 is
                    # DC and nch2/2 is Nyquist (TwoStageFilterBank.m:102-105).
                    # The matlab 1-based overlapping assignment keeps tmp[j]
                    # for j<nch2/2-1 and tmp[j+offset] for j>=nch2/2-1 (second
                    # write wins at the seam).
                    half = nch2 // 2
                    out2 = corner_turn(out2, torch.cat(
                        [out2[:, :, :half - 1, :],
                         out2[:, :, half - 1 + offset: nch2 + offset, :]], dim=2))
            out = corner_turn(out2, out2.reshape(n_pol, nch1 * out2.shape[2], t2))
        return TwoStageFilterBankState(s1, s2), out


@dataclasses.dataclass
class TwoStageInverseFilterBankState:
    stage2: InverseFilterBankState


class TwoStageInverseFilterBank(nn.Module):
    """Per-coarse-channel inverse cascade (TwoStageInverseFilterBank.m).

    Detects critical vs oversampled input from the per-coarse-channel count
    (:100-115) and feeds ``nch2*combine``-channel slabs through one batched
    Golden inversion. ``dedispersion``: each coarse channel dedispersed
    inside the inversion at its centre frequency (the module's docstring).
    """

    def __init__(self, config, config2=None, *, single=False, combine=1,
                 nch2: Optional[int] = None, device="cuda", plain=False,
                 dedispersion: Optional[Dedispersion] = None):
        super().__init__()
        self.config1 = config
        self.config2 = config2 if config2 is not None else config
        self.single = single
        self.combine = combine
        self.nch2 = nch2 if nch2 is not None else self.config2.channels
        self.spectral_taper = "no_window"
        self.device, self.plain = torch.device(device), plain
        self.dedispersion = dedispersion
        #: the batched inversion, built by the first init_state and kept
        #: (with its constants) by the next ones
        self._inv = None
        #: the coarse channels the inversion's chirp table was built for
        self._chirp_rows = None

    def frequency_taper(self, name) -> "TwoStageInverseFilterBank":
        self.spectral_taper = name
        self._inv = None
        return self

    def init_state(self) -> TwoStageInverseFilterBankState:
        os = Rational.coerce(self.config2.os_factor)
        critical_nchan = os.normalize(self.config2.channels)
        monotonic = self.config2.analysis_function == LOWCBF
        # a LowCBF stage 2 emits its KEPT (216) channel subset, fftshifted
        # (ops/lowcbf.py): that count is its "oversampled" full set
        full_nchan = ((self.config2.kept_channels or self.config2.channels)
                      if monotonic else self.config2.channels)
        if self.nch2 == critical_nchan:
            critical = True
        elif self.nch2 == full_nchan:
            critical = False
            if self.combine > 1:
                raise ValueError("cannot combine oversampled coarse channels")
        else:
            raise ValueError(
                f"invalid per-coarse channel count {self.nch2}: stage2 has "
                f"{full_nchan} ({critical_nchan} critical)"
            )
        if critical and self.dedispersion is not None:
            raise ValueError("dedispersion takes the oversampled slab, not the critical one")
        self._critical, self._monotonic = critical, monotonic
        if self._inv is None:
            self._inv = InverseFilterBank(
                self.config2, critical=critical, combine=self.combine,
                spectral_taper=self.spectral_taper, monotonic=monotonic,
                device=self.device, plain=self.plain,
                overlap=None if self.dedispersion is None else self.dedispersion_overlap(),
            )
            self._chirp_rows = None
        self._geom = geometry.SynthesisGeometry(
            self.nch2 * self.combine, self._inv.n_fft, self._inv.overlap, self._inv.os_factor)
        return TwoStageInverseFilterBankState(self._inv.init_state())

    def dedispersion_overlap(self) -> int:
        """The input overlap the inversion discards a side when it
        dedisperses: the configuration's, which the temporal taper spans,
        plus the chirp's reach of the lowest coarse channel (the band's
        widest) in whole input samples, rounded up to a multiple of nu so
        that the output discard is whole output samples. ValueError where
        that leaves nothing of a frame to keep, naming the frame lengths the
        fused inversion has plans for at this channel count and what each
        would keep."""
        d, c = self.dedispersion, self.config2
        os = Rational.coerce(c.os_factor)
        taper, frame = c.input_overlap, c.input_fft_length
        per = os.de * self.nch2 * self.combine / os.nu  # output samples an input sample
        need = taper + math.ceil(d.reach() / per)
        need = -(-need // os.nu) * os.nu
        if 2 * need >= frame:
            n_chan = self.nch2 * self.combine
            plans = "; ".join(f"L {L}, which would keep {max(L - 2 * need, 0)} of each frame"
                              for L in frame_lengths(n_chan))
            raise ValueError(
                f"DM {d.dm}: the chirp of the {d.first_centre_mhz} MHz coarse channel reaches "
                f"{d.reach():.0f} samples; beside the temporal taper's {taper * per:.0f} the "
                f"inversion would discard an input overlap of {need} a side, which leaves "
                f"nothing of its {frame}-sample frames: it needs a longer inversion ("
                + (f"the fused inversion of {n_chan} channels takes {plans})" if plans else
                   f"the fused inversion has no plan for {n_chan} channels)"))
        return need

    @spanned("two_stage.inverse_filterbank")
    def execute(self, state: TwoStageInverseFilterBankState, x
                ) -> Tuple[TwoStageInverseFilterBankState, torch.Tensor]:
        """(n_pol, nchan, n) fine channels -> (new_state, (n_pol, nch_out,
        T_out)), nch_out = nchan // (nch2 * combine) coarse channels."""
        x = as_tensor(x, self.device)
        n_pol, nchan, n_dat = x.shape
        nch_in = self.nch2 * self.combine
        nch_out = 1 if self.single else nchan // nch_in
        if self.dedispersion is not None and self._chirp_rows != nch_out:
            with span("chirp_table"):
                table = self.dedispersion.table(self._geom.output_fft_length, nch_out,
                                                centred=self._monotonic)
            self._inv.set_spectral_filter(table)
            self._chirp_rows = nch_out
        # batch coarse channels: (n_pol*nch_out, nch_in, T)
        with span("corner_turn"):
            slabs = corner_turn(x, x[:, : nch_out * nch_in, :].reshape(n_pol * nch_out, nch_in,
                                                                      n_dat))
        s2, inv = self._inv.execute(state.stage2, slabs)
        # inv: (n_pol*nch_out, 1, T_out) -> (n_pol, nch_out, T_out)
        return TwoStageInverseFilterBankState(s2), inv.reshape(n_pol, nch_out, inv.shape[2])
