"""In-stream fidelity testers and phase-resolved folding.

The port's copy of :mod:`ska_pst_dsp_tpu.models.testers`, the equivalents
of the reference's TestSignal classes — TestPureTone.m:24-96
(SKAO-CSP_Low_PST_REQ-627 / Mid_REQ-385), TestImpulse.m:31-79
(REQ-697 / REQ-386), TestFrequencyComb.m:15-117 — and PhaseAverage.m:13-45.

Testers follow the streaming protocol ``test(state, x) -> (state, result)``
with result 0 = pass, -1 = fail (matching the reference's convention so
driver sweeps like test_sgcht translate directly). They take tensors (on
any device) or arrays and judge them in numpy, in float64 where the JAX
package does.

One departure from the JAX copy: a tone whose coarse channel lies in a slab
the combine truncation drops (the monotonic critical inversion of lowpsi,
216 % 16 != 0: coarse channels 208-215) raises :class:`NotModeled`, a
ValueError, like the other combinations the tester does not model, where
the JAX tester judges a stream that no longer holds the tone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ska_pst_dsp_tpu_torch.utils.rational import Rational, UNITY

MAX_NFFT_TONE = 8 * 1024 * 1024
MAX_NFFT_COMB = 8 * 1024


def _numpy(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def critical_chomp_index(c: int, nch_orig: int, os: Rational) -> Optional[int]:
    """Output index of original stage-2 channel ``c`` after the critical
    chomp (TwoStageFilterBank.m:102-105: keep tmp[j] for j < nch2/2-1 and
    tmp[j+offset] for j >= nch2/2-1). None if ``c`` is chomped away."""
    nch2 = os.normalize(nch_orig)
    offset = nch_orig - nch2
    half = nch2 // 2
    if c < half - 1:
        return c
    if c >= half - 1 + offset:
        return c - offset
    return None


class NotModeled(ValueError):
    """A combination the testers do not model: a tone in a slab the combine
    truncation drops, an impulse after the band-truncated LowCBF inversion.
    A sweep files it as undefined for the combination, not as a fault."""


@dataclasses.dataclass
class TesterState:
    current: int = 0
    failures: int = 0
    detail: str = ""
    #: measurements actually performed (a run whose every block fell
    #: inside the startup-transient skip has current > 0 but judged == 0
    #: — it proved nothing and must not count as a pass)
    judged: int = 0


class TestPureTone:
    __test__ = False  # not a pytest class

    """After inversion, the maximum spurious response to a pure tone must be
    <= -60 dB (power) relative to the tone (TestPureTone.m:20, dB_max=-60).

    Departure from the reference: TestPureTone.m:40-96 applies the raw-stream
    bin index to *every* channel of channelized data (and blocks on an
    interactive ``pause``), so its channelized path is bit-rotted. Here,
    multi-channel input is tested in the *dominant* channel only (peak at the
    translated baseband bin when the expected channel index is supplied via
    ``n_chan``/``os_factor``, in-channel spurious <= db_max); the FFT length
    is truncated so the expected tone is an exact bin — otherwise
    rectangular-window leakage (-13 dB) would mask the measurement."""

    def __init__(self, frequency: float, db_max: float = -60.0,
                 stages: Sequence = (), critical: bool = False,
                 resample=None, check_bin: bool = True, guard: int = 0,
                 combine: int = 1, nch2_critical: int = 0,
                 lowcbf_stages: Sequence = (), skip: int = 0,
                 monotonic_critical: bool = False):
        self.frequency = frequency
        self.db_max = db_max
        #: initial samples of the tested stream to exclude: the filter
        #: startup transient (tone turn-on convolved with the prototype)
        #: is a property of the test signal's finite support, not of the
        #: filterbank — with it excluded a channelized tone measures at
        #: machine precision (~-150 dB) where the raw window gives ~-50 dB
        self.skip = skip
        #: per-stage flags: stage i is the LowCBF firmware-model filterbank
        #: (fftshifted channel order, KEPT_LO..KEPT_LO+KEPT kept, the
        #: quarter-turn derotation adding q/4 to each channel's baseband)
        self.lowcbf_stages = tuple(lowcbf_stages)
        #: critical inversion with combine>1: the synthesis feeds
        #: ``nch2_critical * combine``-channel slabs through the
        #: combine_channel_permutation — the tone's critical channel moves
        #: to a known slot, shifting the output line by whole channel
        #: bands (exact mapping derived in _expected)
        self.combine = combine
        self.nch2_critical = nch2_critical
        #: inverted critical cascade whose stage-2 channels were monotonic
        #: (fftshifted LowCBF, edge-chomped): slabs assemble in given
        #: order (perm identity), so the output line of a tone in coarse
        #: channel c1, critical fine channel c2, in-channel position phi
        #: is (c1%combine * nk2 + c2 + phi) / (nk2*combine)
        self.monotonic_critical = monotonic_critical
        #: channelization stages of the *tested* stream, outermost first:
        #: sequence of (n_chan, os_factor). Empty = raw/inverted stream.
        self.stages = [(n, Rational.coerce(os)) for n, os in stages]
        self.critical = critical  # last stage critically chomped
        #: (ratio, offset) Fractions mapping the per-channel baseband tone
        #: frequency to the tested stream's units — e.g. a critically
        #: inverted stage (spans_nyquist=False) emits at 3/4 rate with a
        #: half-fine-channel modulation (polyphase_synthesis.m:253-255 keeps
        #: each channel's band starting at its lower edge), so
        #: f_out = f*nu/de + 1/(2*nch2_critical).
        self.resample = resample
        #: check_bin False: only require one dominant line (peak anywhere)
        #: with spurious <= db_max outside +-guard bins — for streams whose
        #: exact bin mapping is impractical to predict (combine>1 inverse
        #: reordering); guard masks the non-integer-bin leakage skirt.
        self.check_bin = check_bin
        self.guard = guard

    def init_state(self) -> TesterState:
        return TesterState()

    def _expected(self, nchan_data: int):
        """(expected channel index or None, baseband tone frequency)."""
        from fractions import Fraction

        f = Fraction(self.frequency).limit_denominator(1 << 24)
        if nchan_data == 1 or not self.stages:
            if self.resample is not None:
                ratio, off = self.resample
                f = f * ratio + off
            return None, f
        chans = []
        stage_nk = []
        for i, (n, os) in enumerate(self.stages):
            fb = f * n
            c = int(round(fb)) % n
            f = (fb - round(fb)) * Fraction(os.de, os.nu)
            if i < len(self.lowcbf_stages) and self.lowcbf_stages[i]:
                # LowCBF stage: channels come fftshifted with only
                # [KEPT_LO, KEPT_LO+KEPT) kept, and the combination of the
                # firmware's quarter-turn derotation with the hop phase
                # shifts each channel's baseband content by q/2 (q the
                # signed fftshifted channel index; measured: odd channels
                # land half-band rotated, even channels unshifted) — see
                # ops/lowcbf.py
                from ..ops import lowcbf as _lowcbf

                q = c - n if c >= n // 2 else c
                kc = (c + n // 2) % n - _lowcbf.KEPT_LO
                c = kc if 0 <= kc < _lowcbf.KEPT else None
                f = f + Fraction(q, 2)
                nk = _lowcbf.KEPT
                if (self.critical and i == len(self.stages) - 1
                        and c is not None):
                    # models/two_stage fftshift-aware chomp of the KEPT
                    # channels down to the critical count: the KEPT stream
                    # is monotonic (DC at its middle), so the redundant
                    # oversampled channels are the band EDGES, off/2 each
                    # end (docs/src/divergences.rst)
                    target = os.normalize(n)
                    off = _lowcbf.KEPT - target
                    if off > 0:
                        if off // 2 <= c < off // 2 + target:
                            c -= off // 2
                        else:
                            c = None
                    nk = target
                stage_nk.append(nk)
            else:
                stage_nk.append(n)
            chans.append(c)
        if self.monotonic_critical and len(self.stages) == 2:
            # inverted monotonic (LowCBF edge-chomped) critical cascade:
            # channels assemble in given order, each slot carrying its
            # band monotonically (in-channel baseband -1/2..1/2 maps to
            # slot position 0..1), so the output line of a tone in fine
            # channel c2 at baseband phi is (w*nk2 + c2 + phi + 1/2)
            # / (nk2*combine) — measured-verified at combine 1 and 16
            if chans[0] is None or chans[1] is None:
                return None, f % 1   # tone in a chomped/dropped band
            nk2 = stage_nk[1]
            w = chans[0] % self.combine
            exp = chans[0] // self.combine
            if nchan_data > 1 and exp >= nchan_data:
                raise NotModeled(
                    f"tone in coarse channel {chans[0]}, which the combine-{self.combine} "
                    f"slab truncation drops ({nchan_data} slabs): not modeled")
            phi = (f + Fraction(1, 2)) % 1
            f = (Fraction(w * nk2 + chans[1], nk2 * self.combine)
                 + phi / (nk2 * self.combine))
            return (
                exp if nchan_data > 1 and exp < nchan_data else None,
                f,
            )
        if self.resample is not None:
            # reduce to the stream's baseband first: integer parts (e.g.
            # the LowCBF q/2 derotation alias) are invisible at this
            # stage's rate and must not leak through the rate scaling
            ratio, off = self.resample
            f = (f % 1) * ratio + off
        if self.combine > 1 and self.nch2_critical:
            # combine>1 critical inversion: slabs of nch2c*combine critical
            # channels, reordered by combine_channel_permutation before the
            # big IFFT. After the one-coarse-stage extraction + resample,
            # f (mod 1) is the tone's band position phi in ONE coarse
            # channel's critical inversion; the permutation moves its
            # critical channel cc = floor(phi*nch2c) (within-slab channel
            # cw = (c1 mod combine)*nch2c + cc) to slot s (perm[s] == cw),
            # so the combined-group line sits at s/(nch2c*combine) plus the
            # within-channel offset scaled by the combine-times-faster rate.
            # Verified against the measured test32 combine=4 line (221/384).
            from ..ops.synthesis import combine_channel_permutation

            nch2c = self.nch2_critical
            nch_in = nch2c * self.combine
            phi = f % 1
            cc = int(phi * nch2c)
            delta = phi - Fraction(cc, nch2c)
            cw = (chans[0] % self.combine) * nch2c + cc
            perm = combine_channel_permutation(nch_in, self.combine)
            s = int(np.argwhere(perm == cw)[0, 0])
            f = Fraction(s, nch_in) + delta / self.combine
            exp = chans[0] // self.combine
            return (
                exp if nchan_data > 1 and exp < nchan_data else None,
                f,
            )
        # flatten the stage channel indices into the output channel axis
        idx: Optional[int] = 0
        total = 1
        for i, ((n, os), c) in enumerate(zip(self.stages, chans)):
            nk = stage_nk[i]
            if self.critical and i == len(self.stages) - 1 and nk == n:
                c = critical_chomp_index(c, n, os)
                nk = os.normalize(n)
            if c is None:
                idx = None
                break
            idx = idx * nk + c
            total *= nk
        if total != nchan_data:
            idx = None  # layout differs (e.g. single-channel subset)
        return idx, f

    def test(self, state: TesterState, x) -> tuple:
        x = _numpy(x)
        seen = x.shape[-1]
        drop = max(0, self.skip - state.current)
        if drop >= seen:
            # the whole block is startup transient — nothing to judge yet
            return dataclasses.replace(state, current=state.current + seen), 0
        if drop:
            x = x[..., drop:]
        n_pol, nchan_data = x.shape[0], x.shape[1]
        exp_chan, fb = self._expected(nchan_data)
        for ipol in range(n_pol):
            if nchan_data > 1:
                # dominant channel carries the tone
                # f64: two cascaded LowCBF gain stages put |x| ~ 1e7 and
                # the f32 square overflows to inf, corrupting the argmax
                ichan = int(
                    (np.abs(x[ipol]).astype(np.float64) ** 2)
                    .sum(axis=-1).argmax()
                )
                if exp_chan is not None and ichan != exp_chan:
                    state = dataclasses.replace(
                        state,
                        failures=state.failures + 1,
                        detail=f"tone in chan {ichan}, expected {exp_chan}",
                    )
                    return state, -1
            else:
                ichan = 0
            v = x[ipol, ichan]
            nfft = min(v.size, MAX_NFFT_TONE)
            # truncate so the tone is an exact FFT bin
            q = fb.denominator
            if q <= nfft:
                nfft = (nfft // q) * q
            v = v[:nfft]
            exp_index = int(round(float(fb % 1) * nfft)) % nfft
            spec_db = 20 * np.log10(np.abs(np.fft.fft(v) / nfft) + 1e-30)
            a_index = int(spec_db.argmax())
            spec_db = spec_db - spec_db[a_index]
            if not self.check_bin:
                g = self.guard
                mask = np.ones(nfft, dtype=bool)
                for d in range(-g, g + 1):
                    mask[(a_index + d) % nfft] = False
                # tiny streams (nfft <= 2*guard) leave nothing to test
                worst = spec_db[mask].max() if mask.any() else -np.inf
                if worst > self.db_max:
                    state = dataclasses.replace(
                        state,
                        failures=state.failures + 1,
                        detail=f"spurious {worst:.1f} dB > {self.db_max}",
                    )
                    return state, -1
                continue
            if a_index != exp_index:
                if a_index == (nfft // 2 + exp_index) % nfft:
                    pass  # band swap (TestPureTone.m:63-66)
                else:
                    state = dataclasses.replace(
                        state,
                        failures=state.failures + 1,
                        detail=(
                            f"peak at {a_index}, expected {exp_index} "
                            f"(chan {ichan}, nfft {nfft})"
                        ),
                    )
                    return state, -1
            mask = np.ones(nfft, dtype=bool)
            mask[a_index] = False
            worst = spec_db[mask].max()
            if worst > self.db_max:
                state = dataclasses.replace(
                    state,
                    failures=state.failures + 1,
                    detail=f"spurious {worst:.1f} dB > {self.db_max}",
                )
                return state, -1
        return dataclasses.replace(
            state, current=state.current + seen, judged=state.judged + 1
        ), 0


class TestImpulse:
    __test__ = False  # not a pytest class

    """After inversion, temporal leakage of an impulse must be <= -60 dB
    outside +-1 sample of the expected peak (TestImpulse.m:26, dB_max=-60).

    Departure from the reference: on *channelized* data the +-1-sample
    criterion cannot hold (the impulse is smeared over the prototype-filter
    support by construction), and TestImpulse.m applies it anyway — another
    bit-rotted path. Here a channelized stream passes when the peak power
    column lands where the filter geometry says (``chan_peak_col``) and all
    power outside the filter-support window (+-``chan_support`` columns) is
    <= db_max; outside the support the polyphase fold contributes exactly
    nothing, so real leakage there means a framing/alignment bug."""

    def __init__(self, offset: int, db_max: float = -60.0,
                 chan_peak_col: Optional[int] = None,
                 chan_support: int = 0):
        self.offset = offset          # expected peak sample of the raw stream
        self.db_max = db_max
        self.chan_peak_col = chan_peak_col
        self.chan_support = chan_support

    def init_state(self) -> TesterState:
        return TesterState()

    def _test_channelized(self, state, x) -> tuple:
        n_pol, n_chan, nsample = x.shape
        col = self.chan_peak_col - state.current
        new_state = dataclasses.replace(state, current=state.current + nsample)
        if not (0 <= col < nsample):
            return new_state, 0
        w = self.chan_support
        for ipol in range(n_pol):
            pcol = (np.abs(x[ipol]) ** 2).sum(axis=0)
            k = int(pcol.argmax())
            if abs(k - col) > 1:
                new_state = dataclasses.replace(
                    new_state,
                    failures=new_state.failures + 1,
                    detail=f"impulse peak col {k}, expected {col}",
                )
                return new_state, -1
            mask = np.ones(nsample, dtype=bool)
            mask[max(0, k - w): k + w + 1] = False
            if mask.any():
                worst = 10 * np.log10(pcol[mask].max() / pcol[k] + 1e-30)
                if worst > self.db_max:
                    new_state = dataclasses.replace(
                        new_state,
                        failures=new_state.failures + 1,
                        detail=(
                            f"channelized leakage {worst:.1f} dB outside "
                            f"+-{w} of col {k}"
                        ),
                    )
                    return new_state, -1
        return new_state, 0

    def test(self, state: TesterState, x) -> tuple:
        x = _numpy(x)
        n_pol, n_chan, nsample = x.shape
        if n_chan > 1:
            if self.chan_peak_col is None:
                raise ValueError(
                    "TestImpulse on channelized data requires chan_peak_col"
                )
            return self._test_channelized(state, x)
        off = self.offset - state.current
        new_state = dataclasses.replace(state, current=state.current + nsample)
        if not (0 <= off < nsample):
            return new_state, 0
        for ipol in range(n_pol):
            for ichan in range(n_chan):
                v = x[ipol, ichan]
                amp_db = 20 * np.log10(np.abs(v) + 1e-30)
                peak_db = amp_db[off]
                mask = np.ones(nsample, dtype=bool)
                mask[max(0, off - 1): off + 2] = False
                worst = (amp_db[mask] - peak_db).max()
                if worst > self.db_max:
                    i = int(np.where(mask, amp_db - peak_db, -np.inf).argmax())
                    new_state = dataclasses.replace(
                        new_state,
                        failures=new_state.failures + 1,
                        detail=f"leakage {worst:.1f} dB at {i} (peak {off})",
                    )
                    return new_state, -1
        return new_state, 0


class TestFrequencyComb:
    __test__ = False  # not a pytest class

    """Verify every expected comb harmonic lands in its expected channel and
    FFT bin with amplitude >= 0.5 (TestFrequencyComb.m:15-117); os-factor
    scaling of the harmonic positions follows the processing level."""

    def __init__(self, frequencies: Sequence[float],
                 os_factor: Rational = UNITY, *, two_stage=False,
                 invert=False, critical=False):
        self.frequencies = np.asarray(frequencies, dtype=np.float64)
        self.os_factor = Rational.coerce(os_factor)
        self.two_stage = two_stage
        self.invert = invert
        self.critical = critical

    def init_state(self) -> TesterState:
        return TesterState()

    def test(self, state: TesterState, x) -> tuple:
        x = _numpy(x)
        n_pol, nchan = x.shape[0], x.shape[1]
        level = 2 if self.two_stage else (1 if nchan > 1 else 0)
        if self.invert:
            level -= 1
        if self.critical:
            level -= 1
        for ipol in range(n_pol):
            for ichan in range(nchan):
                v = x[ipol, ichan]
                nfft = min(v.size, MAX_NFFT_COMB)
                v = v[:nfft]
                spec = np.abs(np.fft.fft(v) / (nfft * nchan))
                hfac = nchan * nfft
                for _ in range(max(level, 0)):
                    hfac = (hfac * self.os_factor.de) // self.os_factor.nu
                for i, f in enumerate(self.frequencies):
                    jchan = (int(np.floor(f * nchan)) + nchan) % nchan
                    if jchan != ichan:
                        continue
                    offset = ichan / nchan
                    iharm = (int(np.floor((f - offset) * hfac)) + nfft) % nfft
                    if spec[iharm] < 0.5:
                        state = dataclasses.replace(
                            state,
                            failures=state.failures + 1,
                            detail=(
                                f"harmonic {i} ({f:.6f}) missing in chan "
                                f"{ichan} bin {iharm}: {spec[iharm]:.3f}"
                            ),
                        )
                        return state, -1
        return dataclasses.replace(state, current=state.current + x.shape[-1]), 0


@dataclasses.dataclass
class PhaseAverageState:
    current: int = 0
    result: Optional[np.ndarray] = None  # (n_pol, n_chan, nbin)
    hits: Optional[np.ndarray] = None


class PhaseAverage:
    """Streaming phase-resolved folding (PhaseAverage.m:13-45): accumulate
    samples into pulse-phase bins of a periodic signal."""

    def __init__(self, frequency: float, nbin: int = 256):
        self.frequency = frequency
        self.nbin = nbin

    def init_state(self) -> PhaseAverageState:
        return PhaseAverageState()

    def average(self, state: PhaseAverageState, data) -> PhaseAverageState:
        data = _numpy(data)
        n_pol, n_chan, nsample = data.shape
        result = state.result
        hits = state.hits
        if result is None:
            result = np.zeros((n_pol, n_chan, self.nbin), dtype=data.dtype)
            hits = np.zeros(self.nbin, dtype=np.int64)
        phase = (np.arange(1, nsample + 1) + state.current) * self.frequency
        ibin = np.mod(np.round(phase * self.nbin).astype(np.int64), self.nbin)
        for b in range(self.nbin):
            sel = ibin == b
            if sel.any():
                result[:, :, b] += data[:, :, sel].sum(axis=2)
        hits += np.bincount(ibin, minlength=self.nbin)
        return PhaseAverageState(
            current=state.current + nsample, result=result, hits=hits
        )
