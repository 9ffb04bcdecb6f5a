"""The one traffic generator: a closed loop with one client, driven by a
traffic file's parameters.

Every mix is a data file ``pstbench/traffic/<name>.json`` that names a
``kind`` and its parameters; nothing here knows a cell. A request is handed
over, its output completes on the card (a synchronise), and only then is
the next handed over: a file or stream reader waits for each reply.

* ``oneshot``: ``samples`` per polarisation, ``windows`` distinct seeded
  inputs made on the device in set-up, requests rotating over them; the
  one-shot round trip (``models.round_trip``).
* ``stream``: one stream replayed from a seeded device buffer of
  ``buffer_samples``, handed over in blocks of ``block`` samples through
  the streaming analysis then inversion with their state carried
  (``models.streaming``); a request is one block.
* ``dada``: a DADA file of ``windows`` windows of ``samples``, written by
  the benchmark's own writer under TMPDIR in set-up (the page cache holds
  it); a request reads one window through ``io.dada.load_split`` and runs
  the round trip.

Each kind says which outputs it keeps for the check (:meth:`record`), the
plain reference it is held to (:meth:`reference`), what that reference says
the outputs should be (:meth:`pairs`), and the least time its work could
take (:meth:`least_seconds`).

A kind that is not one of these three is found by its name: the file
``pstbench/kinds/<kind>.py``, whose ``KIND`` is a :class:`Traffic`
subclass. Its plain reference lives in ``pstbench/references/<name>.py``
(plain ``torch`` and ``numpy`` in float64, nothing of the program;
:func:`load` finds it), and it imports the program itself, inside its
functions, as :mod:`pstbench.system` does.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import dadafile, noise, roofline, system
from .reference import Geometry, Reference, geometry
from .trace import Tracer, tmp_dir


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Traffic:
    """A mix bound to a configuration, a seed and a device."""

    #: requests whose outputs are kept together as one sample for the check
    group = 1

    def __init__(self, params: dict, cfg: dict, filt: np.ndarray, seed: int, device):
        self.params, self.cfg, self.filt, self.seed = params, cfg, filt, seed
        self.device = torch.device(device)
        self.n_pol = int(params["n_pol"])
        self.g: Geometry = geometry(cfg)
        self.warm_requests = int(params["warm_requests"])
        #: file bytes a request reads (0 where it reads none)
        self.bytes_per_request = 0

    samples_per_request: int

    def setup(self) -> None:
        raise NotImplementedError

    def request(self, i: int, tr: Tracer):
        """Hand over request ``i``; return its output, complete on the card."""
        raise NotImplementedError

    def record(self, i: int, out) -> tuple:
        """What the check keeps of request ``i``'s output."""
        raise NotImplementedError

    def pairs(self, records: List[tuple], ref: Reference) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(output, reference) pairs for the kept records."""
        raise NotImplementedError

    def reference(self, device, precision: str = "fp64"):
        """The plain reference that :meth:`pairs` reads, at ``precision``
        (the control's ``bf16`` too): the round trip's by default."""
        return Reference(self.cfg, self.filt, device, precision)

    def least_seconds(self, samples: int, device_name: str) -> Optional[float]:
        """The least time the card ``device_name`` could take over
        ``samples`` complex input samples of this kind's work, counted by
        :mod:`pstbench.roofline`'s rule: the round trip's by default."""
        return roofline.least_seconds(self.g, samples, device_name)

    def free_program(self) -> None:
        """Drop the program's state before the reference runs."""

    def close(self) -> None:
        """Remove what set-up wrote."""


class OneShot(Traffic):
    def setup(self) -> None:
        n = int(self.params["samples"])
        self.windows = int(self.params["windows"])
        self.samples_per_request = self.n_pol * n
        self.x = noise.complex_noise((self.windows, self.n_pol, n), self.seed, 0, self.device)
        self.model = system.round_trip(self.cfg, self.filt, self.device)

    def request(self, i, tr):
        x = self.x[i % self.windows]
        with tr.span("issue"):
            out = self.model(x)
        with tr.span("wait"):
            _sync(self.device)
        return out

    def record(self, i, out):
        return (i % self.windows, out)

    def pairs(self, records, ref):
        want: Dict[int, torch.Tensor] = {}
        out = []
        for w, got in records:
            if w not in want:
                want[w] = ref.round_trip(self.x[w])
            out.append((got[:, 0], want[w]))
        return out

    def free_program(self):
        del self.model


class Dada(OneShot):
    def setup(self) -> None:
        n = int(self.params["samples"])
        self.windows = int(self.params["windows"])
        self.n = n
        self.samples_per_request = self.n_pol * n
        self.bytes_per_request = self.n_pol * n * 8
        self.path = os.path.join(tmp_dir(), f"windows-{os.getpid()}.dada")
        dadafile.write(
            self.path, self.params["header"],
            (noise.complex_noise((self.n_pol, n), self.seed, 1 + w, self.device).cpu().numpy()
             for w in range(self.windows)))
        self.model = system.round_trip(self.cfg, self.filt, self.device)

    def request(self, i, tr):
        w = i % self.windows
        with tr.span("ingest"):
            x = system.load_split(self.path, self.n, w * self.n, self.device)
            if tr.enabled:
                _sync(self.device)
        with tr.span("issue"):
            out = self.model(x[:, 0])
        with tr.span("wait"):
            _sync(self.device)
        return out

    def pairs(self, records, ref):
        want: Dict[int, torch.Tensor] = {}
        out = []
        for w, got in records:
            if w not in want:
                want[w] = ref.round_trip(
                    dadafile.read_window(self.path, self.n_pol, w * self.n, self.n))
            out.append((got[:, 0], want[w]))
        return out

    def close(self):
        if os.path.exists(getattr(self, "path", "")):
            os.remove(self.path)


class Stream(Traffic):
    """Blocks of one long stream through the streaming stages; the output
    of request i is placed in the stream's output by the running count."""

    def setup(self) -> None:
        self.block = int(self.params["block"])
        self.n_buf = int(self.params["buffer_samples"])
        if self.n_buf % self.block:
            raise ValueError("buffer_samples must be a whole number of blocks")
        self.group = int(self.params["blocks_per_sample"])
        self.samples_per_request = self.n_pol * self.block
        self.buf = noise.complex_noise((self.n_pol, self.n_buf), self.seed, 0, self.device)
        self.fb, self.inv = system.stream(self.cfg, self.filt, self.device)
        self.states = [self.fb.init_state(), self.inv.init_state()]
        self.emitted = 0

    def request(self, i, tr):
        a = (i * self.block) % self.n_buf
        with tr.span("issue"):
            self.states[0], y = self.fb.execute(self.states[0], self.buf[:, a:a + self.block])
            self.states[1], z = self.inv.execute(self.states[1], y)
        with tr.span("wait"):
            _sync(self.device)
        self.emitted += z.shape[-1]
        return z

    def record(self, i, out):
        return (self.emitted - out.shape[-1], out)

    def input(self, start: int, n: int) -> torch.Tensor:
        """Stream samples [start, start + n): the buffer replayed."""
        idx = (torch.arange(start, start + n, device=self.device) % self.n_buf)
        return self.buf[:, idx]

    def expected(self, a: int, b: int, ref: Reference) -> torch.Tensor:
        """The stream's output samples [a, b), from the reference's one-shot
        round trip of a stretch of the input aligned with the derotation
        and the inversion's blocks, begun early enough (padded analysis)
        that its zero history has left the compared blocks."""
        g = self.g
        first, last = a // g.out_keep, -(-b // g.out_keep)
        warm = 0
        if g.padded:
            warm = -(-max(0, -(-g.fl // g.step) - g.delay) // g.keep) + 1
        align = g.ramp_period // math.gcd(g.keep, g.ramp_period)
        s0 = max(0, first - warm) // align * align
        tail = -(-g.delay // g.keep) + 1 if g.padded else 0
        n_in = g.in_len(last - s0 + tail)
        out = ref.round_trip(self.input(s0 * g.keep * g.step, n_in))
        o0 = s0 * g.out_keep
        return out[:, a - o0:b - o0]

    def pairs(self, records, ref):
        out = []
        for group in _runs(records):
            a = group[0][0]
            got = torch.cat([z for _, z in group], dim=-1)[:, 0]
            out.append((got, self.expected(a, a + got.shape[-1], ref)))
        return out

    def free_program(self):
        del self.fb, self.inv, self.states


def _runs(records: List[tuple]) -> List[List[tuple]]:
    """Records split into runs of contiguous output."""
    runs: List[List[tuple]] = []
    for r in records:
        if runs and runs[-1][-1][0] + runs[-1][-1][1].shape[-1] == r[0]:
            runs[-1].append(r)
        else:
            runs.append([r])
    return runs


KINDS = {"oneshot": OneShot, "stream": Stream, "dada": Dada}


def load(folder: str, name: str):
    """The benchmark's file ``pstbench/<folder>/<name>.py``, loaded by
    path (:func:`pstbench.run.load_module`); a ValueError naming the file
    where there is none."""
    from . import run

    path = run.HERE / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"{name!r} is not in pstbench/{folder}: no file {path}")
    return run.load_module(path)


def kind(name: str) -> type:
    """The traffic kind ``name``: one of :data:`KINDS`, else the ``KIND``
    of ``pstbench/kinds/<name>.py``."""
    if name in KINDS:
        return KINDS[name]
    cls = getattr(load("kinds", name), "KIND", None)
    if not (isinstance(cls, type) and issubclass(cls, Traffic)):
        raise ValueError(f"pstbench/kinds/{name}.py has no KIND that is a Traffic subclass")
    return cls


def make(params: dict, cfg: dict, filt: np.ndarray, seed: int, device) -> Traffic:
    """The mix ``params`` (a traffic file's contents) bound to a config."""
    return kind(params["kind"])(params, cfg, filt, seed, device)
