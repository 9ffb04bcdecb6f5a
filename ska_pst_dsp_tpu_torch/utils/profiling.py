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
  card, the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Dict, Optional

import torch

module_logger = logging.getLogger(__name__)


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
