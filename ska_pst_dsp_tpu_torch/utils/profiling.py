"""Tracing / profiling helpers.

The port's counterpart of :mod:`ska_pst_dsp_tpu.utils.profiling`. The
reference sprinkles tic/toc prints through every kernel and driver
(polyphase_analysis.m:40,124-127; sgcht.m:502,577-578). Here:

* :class:`StageTimer` — per-stage wall-clock + samples/s counters with a
  one-line report, for driver block loops. PyTorch returns before the card
  has done the work it was given, so a timer on a CUDA device synchronises
  it as each stage ends: a stage's time holds its device work, not only
  the enqueue;
* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace into a directory when profiling is requested
  (``SKA_PST_TRACE_DIR`` or an explicit path), and a no-op otherwise, so
  drivers can leave it permanently in place;
* :func:`clock` — a stopwatch for the work on a device: CUDA events on a
  card, the host clock on the CPU;
* :func:`span` and :func:`spanned` — the program's own spans at its layer
  boundaries, ``pst:<name>`` events on the host in the profiler's trace
  while a profiler records (a :func:`trace` scope, or any other
  ``torch.profiler`` run), and a shared null context otherwise;
* :func:`counters` — every counter of the program in one dict.

The spans, by layer (each nests in the one above it on the host thread):

* chain and stream: ``forward`` (the one-shot round trips),
  ``filterbank`` and ``inverse_filterbank`` (the streaming stages'
  ``execute``), ``carry`` (each carry's ``torch.cat`` in those);
  ``two_stage.filterbank`` and ``two_stage.inverse_filterbank`` (the
  cascades' ``execute``, around their stages' spans) and ``corner_turn``
  (in those, around the cascade's own reshapes: stage 1's spectra into
  one stream per coarse channel, the chomp and the output's layout, the
  inverse's slabs) and ``chirp_table`` (in ``two_stage.inverse_filterbank``:
  building the coherent-dedispersion chirps of its coarse channels, once
  per channel count);
* wrappers: ``kernel.<name>`` (each of the eleven kernel wrappers, under its
  key in :func:`..ops.kernels.wrappers`), ``inversion``
  (``fused_inversion``), ``dispatch`` (the epilogue's choice of route,
  ending before the chosen epilogue is called) and ``composed_epilogue``
  (in ``inversion``: the composed epilogue, where no kernel's plan covers
  the block's length).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from typing import Callable, Dict, Optional

import torch

module_logger = logging.getLogger(__name__)

#: prefix of the program's annotations in the profiler's trace
PREFIX = "pst:"
_recording = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def _scope(label: str):
    """The profiler's record of one span: torch's fast RecordFunction (a
    ``cpu_op`` event in the trace; a fraction of ``record_function``'s
    cost while the profiler records), else ``record_function``."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return torch.profiler.record_function(label) if fast is None else fast(label)


def span(name: str):
    """The span ``"pst:" + name`` while a profiler records; otherwise one
    shared null context, so that a span costs one C call and a ``with``
    when nobody traces."""
    return _scope(PREFIX + name) if _recording() else _OFF


def spanned(name: str):
    """Decorator: the whole call of the function is the span ``name``
    (:func:`span`); with no profiler recording the function is called
    straight, which costs less than a ``with span()``."""
    label = PREFIX + name

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _scope(label):
                return fn(*args, **kwargs)
        return call
    return wrap


def counters() -> Dict[str, int]:
    """Every counter of the program: each kernel wrapper's ``launches``
    (by its key in :func:`..ops.kernels.wrappers`), the channel-major ones
    among the analysis's (``analysis_fused.channel_major_launches``) as
    ``analysis_fused_channel_major``, the fused inversion's launches whose
    input lay in two tensors (``inversion_fused.split_launches``) as
    ``inversion_fused_split``,
    ``fused_inversion.composed_epilogues`` as ``composed_epilogues``, the
    points of every inversion transform and the output samples they kept
    (``fused_inversion.transform_points``, ``fused_inversion.output_samples``)
    as ``inversion_transform_points`` and ``inversion_output_samples``, the
    bytes the streaming stages' carries have written
    (``models.streaming.carry.bytes``) as ``carry_bytes``, and the bytes
    the cascades' corner turns have copied
    (``models.two_stage.corner_turn.bytes``) as ``corner_turn_bytes``. Each
    counts from the process's start; take the difference of two readings."""
    from ..models import streaming, two_stage
    from ..ops.kernels import wrappers
    from ..ops.kernels.analysis_fused import analysis_fused
    from ..ops.kernels.inversion_fused import inversion_fused
    from ..ops.kernels.synthesis_fused import fused_inversion

    out = {k: w.launches for k, w in wrappers().items()}
    out["analysis_fused_channel_major"] = analysis_fused.channel_major_launches
    out["inversion_fused_split"] = inversion_fused.split_launches
    out["composed_epilogues"] = fused_inversion.composed_epilogues
    out["inversion_transform_points"] = fused_inversion.transform_points
    out["inversion_output_samples"] = fused_inversion.output_samples
    out["carry_bytes"] = streaming.carry.bytes
    out["corner_turn_bytes"] = two_stage.corner_turn.bytes
    return out


def clock(device: torch.device) -> Callable[[], float]:
    """A stopwatch for work on ``device``: CUDA events on a card, the host
    clock on the CPU. Call it to start; call what it returns to stop and
    read ms (it waits for the card's work)."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()

        def stop():
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        return stop
    t0 = time.perf_counter()
    return lambda: (time.perf_counter() - t0) * 1e3


class StageTimer:
    """Accumulate wall-clock and item counts per named stage.

    >>> t = StageTimer(device)
    >>> with t.stage("analysis", samples=n):
    ...     out = analyze(x)
    >>> t.report()
    """

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}
        self.items: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, samples: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.items[name] = self.items.get(name, 0) + samples

    def report(self, log=None) -> Dict[str, dict]:
        out = {}
        for name, sec in self.seconds.items():
            n = self.items.get(name, 0)
            entry = {"seconds": round(sec, 4)}
            if n and sec > 0:
                entry["msamples_per_s"] = round(n / sec / 1e6, 2)
            out[name] = entry
            (log or module_logger.info)("%s: %s", name, entry)
        return out


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """torch.profiler scope (CPU, and CUDA where there is a card) writing
    one Chrome trace file per scope into the directory; no-op unless a
    directory is given or SKA_PST_TRACE_DIR is set."""
    trace_dir = trace_dir or os.environ.get("SKA_PST_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"trace.{os.getpid()}.{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    module_logger.info("profiler trace written to %s", path)
