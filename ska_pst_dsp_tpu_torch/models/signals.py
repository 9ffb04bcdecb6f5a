"""Test-signal generators.

Counterpart of :mod:`ska_pst_dsp_tpu.models.signals` (PureTone.m,
Impulse.m, SquareWave.m, FrequencyComb.m, FrequencyWedge.m, DADARead.m).
Generators are stateless functions of absolute sample position:
``generate(start, n)`` returns samples [start, start+n) as a
(n_pol, 1, n) complex64 tensor on the generator's ``device`` (default the
card), so any block split gives the same samples; :class:`Stream` adds the
reference's stateful ``generate(n)`` surface.

The deterministic generators (:class:`PureTone`, :class:`FrequencyComb`
and a noise-free :class:`Impulse`) take their phase in float64 on the host
and equal the JAX package's sample for sample.

Noise: the JAX package draws each 16384-sample tile from threefry keys
(``fold_in(key, tile)``) through an erfinv normal, which torch has no way
to reproduce. Here each tile (and each :class:`FrequencyWedge` segment)
draws its normals from a ``torch.Generator`` on the device seeded from
(seed, stream, tile), so sample t still has one value whatever the
blocking (on a given device: the CPU's and the card's generators differ).
The noisy generators (:class:`Impulse`'s floor, :class:`SquareWave`,
:class:`FrequencyWedge`, :class:`GaussianNoise`) are therefore held to
JAX's by their statistics, not sample by sample: unit variance per
quadrature (2 per complex sample), zero mean, the square wave's on/off
power ratio and the wedge's spectral slope.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

TILE = 16384
#: noise stream of FrequencyWedge's segments (tiles use stream 0, or
#: 1000 + polarization for GaussianNoise, as the JAX package's keys do)
WEDGE_STREAM = 1 << 20


def _generator(device: torch.device, *key: int) -> torch.Generator:
    """A torch.Generator on ``device`` seeded from the integers ``key``."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _tiled_noise(seed: int, stream: int, start: int, n: int,
                 device: torch.device) -> torch.Tensor:
    """(n,) complex64 noise, unit variance per quadrature, for absolute
    positions [start, start+n): tile ti holds the normals of the generator
    seeded from (seed, stream, ti), whatever the blocking."""
    t0 = start // TILE
    t1 = (start + n - 1) // TILE + 1
    tiles = [torch.randn((2, TILE), generator=_generator(device, seed, stream, ti),
                         device=device) for ti in range(t0, t1)]
    full = torch.cat(tiles, dim=1)
    off = start - t0 * TILE
    return torch.complex(full[0, off: off + n], full[1, off: off + n])


def _host(x: np.ndarray, device) -> torch.Tensor:
    """A host complex array as (1, 1, n) complex64 on ``device``."""
    return torch.as_tensor(x.astype(np.complex64)[None, None, :], device=torch.device(device))


class SignalGenerator:
    """Protocol: generate(start, n) -> (n_pol, 1, n) complex64 tensor."""

    n_pol = 1

    def generate(self, start: int, n: int) -> torch.Tensor:
        raise NotImplementedError

    def stream(self) -> "Stream":
        return Stream(self)


@dataclasses.dataclass
class Stream:
    """Stateful adapter with the reference Generator surface
    (``[obj, x] = generate(obj, n)``)."""

    gen: SignalGenerator
    current: int = 0

    def generate(self, n: int) -> torch.Tensor:
        x = self.gen.generate(self.current, n)
        self.current += n
        return x


@dataclasses.dataclass
class PureTone(SignalGenerator):
    """Phase-continuous complex sinusoid (PureTone.m:12-27)."""

    frequency: float = 1 / 26.5  # cycles per sample
    amplitude: float = 1.0
    device: str = "cuda"

    def generate(self, start: int, n: int) -> torch.Tensor:
        t = np.arange(start, start + n, dtype=np.float64)
        # phase in f64 on the host: at sample ~1e9 an f32 phase error would
        # swamp the -60 dB purity floor
        phase = 2.0 * np.pi * ((self.frequency * t) % 1.0)
        return _host(self.amplitude * np.exp(1j * phase), self.device)


@dataclasses.dataclass
class Impulse(SignalGenerator):
    """Unit impulse at ``offset`` over a small complex noise floor
    (Impulse.m:13-40)."""

    offset: int = 0
    amplitude: float = 1.0
    noise: float = 1e-6
    seed: int = 0
    device: str = "cuda"

    def generate(self, start: int, n: int) -> torch.Tensor:
        dev = torch.device(self.device)
        if self.noise != 0:
            x = self.noise * _tiled_noise(self.seed, 0, start, n, dev)
        else:
            x = torch.zeros(n, dtype=torch.complex64, device=dev)
        if start <= self.offset < start + n:
            x[self.offset - start] = self.amplitude
        return x[None, None, :]


@dataclasses.dataclass
class SquareWave(SignalGenerator):
    """Amplitude-modulated complex noise: on-pulse std sqrt(on_amp/2) per
    quadrature for the first duty_cycle of each period (SquareWave.m:14-63)."""

    period: int = 26
    duty_cycle: float = 0.5
    on_amp: float = 1.0
    off_amp: float = 0.0
    seed: int = 0
    device: str = "cuda"

    def generate(self, start: int, n: int) -> torch.Tensor:
        dev = torch.device(self.device)
        t = torch.arange(start, start + n, dtype=torch.int64, device=dev)
        ioff = int(np.floor(self.period * self.duty_cycle))
        amp = torch.where((t % self.period) < ioff, float(np.sqrt(self.on_amp * 0.5)),
                          float(np.sqrt(self.off_amp * 0.5))).to(torch.float32)
        return (amp * _tiled_noise(self.seed, 0, start, n, dev))[None, None, :]


@dataclasses.dataclass
class FrequencyComb(SignalGenerator):
    """Sum of phase-continuous tones with an amplitude slope
    (FrequencyComb.m:11-48; sgcht.m:492-530 builds 32 harmonics with
    amplitudes linspace(1, sqrt(2)))."""

    amplitudes: Sequence[float] = ()
    frequencies: Sequence[float] = ()
    device: str = "cuda"

    @classmethod
    def standard(cls, nharmonic: int = 32, fmin: Optional[float] = None,
                 fmax: Optional[float] = None, device="cuda") -> "FrequencyComb":
        amplitudes = np.linspace(1.0, np.sqrt(2.0), nharmonic)
        if fmin is None:
            fmin = -0.5 + 1.0 / (nharmonic * 4)
        if fmax is None:
            fmax = fmin + (nharmonic - 1.0) / nharmonic
        frequencies = np.linspace(fmin, fmax, nharmonic)
        return cls(tuple(amplitudes), tuple(frequencies), device)

    def generate(self, start: int, n: int) -> torch.Tensor:
        t = np.arange(start, start + n, dtype=np.float64)
        x = np.zeros(n, dtype=np.complex128)
        for a, f in zip(self.amplitudes, self.frequencies):
            x += a * np.exp(2j * np.pi * ((f * t) % 1.0))
        return _host(x, self.device)


@dataclasses.dataclass
class FrequencyWedge(SignalGenerator):
    """Broadband noise with a sqrt-linear spectral slope, generated per
    ``resolution``-sample segment through an IFFT of sloped complex-noise
    spectra (FrequencyWedge.m:13-61). Each segment's spectrum is seeded by
    its absolute segment index, so blocking doesn't change the stream."""

    resolution: int = 1024 * 1024
    seed: int = 0
    device: str = "cuda"

    def _segment(self, seg_idx: int) -> torch.Tensor:
        dev = torch.device(self.device)
        r = torch.randn((2, self.resolution), device=dev,
                        generator=_generator(dev, self.seed, WEDGE_STREAM, seg_idx))
        slope = torch.as_tensor(np.sqrt(np.fft.fftshift(np.linspace(0, 1, self.resolution)))
                                .astype(np.float32), device=dev)
        return torch.fft.ifft(torch.complex(slope * r[0], slope * r[1]))

    def generate(self, start: int, n: int) -> torch.Tensor:
        out = []
        pos, remaining = start, n
        while remaining > 0:
            seg = pos // self.resolution
            off = pos - seg * self.resolution
            take = min(remaining, self.resolution - off)
            out.append(self._segment(seg)[off: off + take])
            pos += take
            remaining -= take
        return torch.cat(out)[None, None, :]


@dataclasses.dataclass
class GaussianNoise(SignalGenerator):
    """Flat complex noise (the reference harness's ``generate_test_vector
    func='noise'`` backend, generate_test_vector.py)."""

    scale: float = 1.0
    seed: int = 0
    n_pol: int = 1
    device: str = "cuda"

    def generate(self, start: int, n: int) -> torch.Tensor:
        dev = torch.device(self.device)
        pols = [self.scale * _tiled_noise(self.seed, 1000 + p, start, n, dev)
                for p in range(self.n_pol)]
        return torch.stack(pols)[:, None, :]


class DADAReadGenerator(SignalGenerator):
    """File-backed generator (DADARead.m): successive generate calls stream
    through a DADA file, LowCBF heap files included (:mod:`..io.dada`)."""

    def __init__(self, path: str, device="cuda"):
        from ..io import dada

        self.path = path
        self.device = torch.device(device)
        self.header = dada.read_header(path)
        self.n_pol = int(self.header.get("NPOL", 1))
        self.n_chan = int(self.header.get("NCHAN", 1))

    def generate(self, start: int, n: int) -> torch.Tensor:
        from ..io import dada

        data, _ = dada.load(self.path, count=n, offset_samples=start)
        return torch.as_tensor(data, device=self.device)


def make_generator(name: str, header: dict, *, n_chan: int = 1,
                   tsamp: Optional[float] = None, **kwargs) -> SignalGenerator:
    """Construct a generator the way sgcht does from a signal name and header
    template (sgcht.m:360-477): square_wave period from CALFREQ, tone
    frequency from TONEFREQ, etc. Keyword arguments (``device`` among them)
    go to the generator."""
    tsamp = float(header.get("TSAMP", 1.0)) if tsamp is None else tsamp
    if name == "square_wave":
        calfreq = float(header.get("CALFREQ", 1.0))  # Hz
        period = int(round(1e6 / (calfreq * tsamp)))
        return SquareWave(period=period, **kwargs)
    if name == "complex_sinusoid":
        tonefreq = float(header.get("TONEFREQ", 250000.0))  # kHz
        return PureTone(frequency=(tonefreq * tsamp) / 1e6, **kwargs)
    if name == "temporal_impulse":
        return Impulse(offset=kwargs.pop("offset", 20000), **kwargs)
    if name == "frequency_comb":
        return FrequencyComb.standard(**kwargs)
    if name == "frequency_wedge":
        return FrequencyWedge(**kwargs)
    if name == "noise":
        return GaussianNoise(**kwargs)
    raise ValueError(f"unrecognized signal: {name}")
