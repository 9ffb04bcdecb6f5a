"""Block-geometry arithmetic for the oversampled PFB pipeline.

The port's copy of :mod:`ska_pst_dsp_tpu.utils.geometry`: pure-integer
helpers shared by the kernel wrappers and the modules, the equivalents of
the reference's size math (pad_filter.m:9-13, calc_output_nbins.m:17-27,
polyphase_analysis.m:56-62, polyphase_synthesis.m:112-118,
polyphase_analysis_padded.m:89). Everything here runs on the host, so every
kernel shape is a plain integer before launch.
"""

from __future__ import annotations

import dataclasses

from .rational import Rational


def padded_filter_length(n_taps: int, n_chan: int) -> int:
    """Length after zero-padding taps to a whole number of channels
    (pad_filter.m:9-13)."""
    phases = -(-n_taps // n_chan)  # ceil
    return phases * n_chan


def analysis_step(n_chan: int, os_factor: Rational) -> int:
    """Commutator advance per output spectrum: floor(n_chan*de/nu)
    (polyphase_analysis.m:56)."""
    return os_factor.normalize_floor(n_chan)


def analysis_nblocks(n_dat: int, n_taps: int, n_chan: int, os_factor: Rational) -> int:
    """Number of output spectra of the non-padded analysis PFB
    (polyphase_analysis.m:62)."""
    fl = padded_filter_length(n_taps, n_chan)
    step = analysis_step(n_chan, os_factor)
    return (n_dat - fl) // step


def analysis_padded_nblocks(n_dat: int, n_chan: int, os_factor: Rational) -> int:
    """Number of output spectra of the zero-padded analysis PFB
    (polyphase_analysis_padded.m:75)."""
    return n_dat // analysis_step(n_chan, os_factor)


def padded_sample_delay_shift(n_taps: int, n_chan: int, os_factor: Rational) -> int:
    """Output time-axis shift applied by the padded analysis so its group
    delay matches the non-padded variant (polyphase_analysis_padded.m:89)."""
    step = analysis_step(n_chan, os_factor)
    return -((-(n_taps - 1)) // (2 * step))  # ceil((n_taps-1)/(2*step))


@dataclasses.dataclass(frozen=True)
class SynthesisGeometry:
    """Static block geometry of the Golden FFT-based inversion
    (polyphase_synthesis.m:112-136)."""

    n_chan: int
    input_fft_length: int
    input_overlap: int
    os_factor: Rational

    @property
    def input_keep(self) -> int:
        return self.input_fft_length - 2 * self.input_overlap

    @property
    def output_fft_length(self) -> int:
        return self.os_factor.normalize(self.input_fft_length) * self.n_chan

    @property
    def output_overlap(self) -> int:
        return self.os_factor.normalize(self.input_overlap) * self.n_chan

    @property
    def output_keep(self) -> int:
        return self.output_fft_length - 2 * self.output_overlap

    @property
    def fn_width(self) -> int:
        """Passband bins kept per fine channel (polyphase_synthesis.m:133)."""
        return self.os_factor.normalize(self.input_fft_length)

    @property
    def discard(self) -> int:
        """Transition bins dropped per side of each fine-channel spectrum
        (polyphase_synthesis.m:136)."""
        return (self.input_fft_length - self.fn_width) // 2

    def n_blocks(self, n_dat: int) -> int:
        """Overlap-save block count for an n_dat-sample fine-channel stream
        (polyphase_synthesis.m:114)."""
        return (n_dat - 2 * self.input_overlap) // self.input_keep

    def output_ndat(self, n_dat: int) -> int:
        return self.n_blocks(n_dat) * self.output_keep


def calc_output_nbins(
    nbins: int,
    channels: int,
    os_factor: Rational,
    filter_taps: int,
    input_fft_length: int,
    input_overlap: int,
) -> int:
    """End-to-end output length through analysis + inversion
    (calc_output_nbins.m:17-27)."""
    step = analysis_step(channels, os_factor)
    nblocks_pfb = (nbins - filter_taps) // step
    output_pfb = (step * nblocks_pfb) // channels
    geom = SynthesisGeometry(channels, input_fft_length, input_overlap, os_factor)
    return geom.output_ndat(output_pfb)


def total_sample_shift(
    channels: int,
    os_factor: Rational,
    filter_taps: int,
    input_overlap: int,
    *,
    padded: bool = False,
) -> int:
    """Input samples to discard when aligning inverted output against the
    original input (python/verify/purity.py:95-99 in the reference).

    Non-padded analysis leaves the FIR group delay in the stream, so the
    shift is overlap + (taps-1)//2. The padded (SKA-Mid) analysis removes
    its own group delay internally — it advances the output by
    ``padded_sample_delay_shift`` spectra (polyphase_analysis_padded.m:89)
    and indexes its newest input sample at ``idx*step - 1``
    (polyphase_analysis_padded.m:121-126) — leaving out[t] = x[t - 1], so
    the shift is output_overlap - 1 (verified at the production mid
    geometry in tests/test_mid_production.py and
    tests/test_current_performance.py). The spectrum-quantized advance
    assumes (taps-1)/2 is a multiple of step, true for every production
    padded config; other tap counts smear the reconstruction itself
    (measured: ~-3 dB impulse amplitude at residual 126), so no shift
    formula can align them."""
    output_sample_shift = os_factor.normalize(input_overlap) * channels
    if padded:
        return output_sample_shift - 1
    return output_sample_shift + (filter_taps - 1) // 2
