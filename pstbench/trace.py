"""Spans around the calls into each layer, and the profiler's device trace.

The harness records a span around each call into the program's layers
(``request`` and, inside it, ``ingest``, ``issue`` and ``wait``). Spans
are kept in memory only in a traced run and written under TMPDIR when the
run ends. A traced run also profiles a steady stretch of the window with
``torch.profiler``; :func:`read_trace` turns the exported trace into the
device's operations and the host spans on one clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

from . import stats

#: prefix of the harness's annotations in the profiler's trace
PREFIX = "pstbench:"
#: the traced run's breakdown lists at most this many entries a list
BREAKDOWN = 10
#: trace categories of operations on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_OFF = contextlib.nullcontext()


class Tracer:
    """Spans (name, request, start, end) on the host clock, and in a
    profiled stretch the same spans as profiler annotations."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.spans: List[Tuple[str, int, float, float]] = []
        self.request = -1

    def span(self, name: str):
        """A context that records the span ``name`` (nothing when off)."""
        return self._span(name) if self.enabled else _OFF

    @contextlib.contextmanager
    def _span(self, name: str):
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name):
            yield
        self.spans.append((name, self.request, t0, time.perf_counter()))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([{"name": n, "request": r, "start": a, "end": b}
                       for n, r, a, b in self.spans], f)


class Profile:
    """``torch.profiler`` over a stretch of the window, started and
    stopped between requests."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.first = self.last = None  # requests inside the stretch

    def start(self, request: int) -> None:
        self.prof.start()
        self.first = request

    def stop(self, request: int) -> None:
        self.prof.stop()
        self.last = request

    def export(self, path: str) -> None:
        self.prof.export_chrome_trace(path)


def _clean(name: str) -> str:
    """A device operation's name without ``void``, namespaces, template
    arguments or parameters."""
    name = name.removeprefix("void ").replace("at::native::", "")
    name = name.replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0] or name[:40]


def read_trace(path: str) -> Dict[str, list]:
    """{"device": [(name, start_us, end_us)], "spans": [(name, start_us,
    end_us)]} from a chrome trace: every operation on the device, and the
    harness's annotations on the host."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    device, spans = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        a = float(ev["ts"])
        b = a + float(ev["dur"])
        if cat in DEVICE_CATS:
            device.append((_clean(name), a, b))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], a, b))
    return {"device": device, "spans": spans}


def span_at(spans: List[Tuple[str, float, float]], t: float) -> Optional[str]:
    """The innermost span that holds time ``t``."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return None if best is None else best[0]


def tmp_dir() -> str:
    """The benchmark's directory under TMPDIR (made if missing)."""
    import tempfile

    d = os.path.join(tempfile.gettempdir(), "pstbench")
    os.makedirs(d, exist_ok=True)
    return d


@dataclasses.dataclass
class TraceData:
    """The profiled stretch, on the profiler's clock (microseconds)."""

    window: tuple                 # (start, end) of the traced requests
    device: List[tuple]           # (name, start, end) of each device operation
    spans: List[tuple]            # (name, start, end) of the harness's spans
    requests: int                 # requests wholly inside the stretch


def read_profile(prof: Profile, path: str) -> Optional[TraceData]:
    """The profiled stretch, read from the trace exported to ``path``
    (removed after)."""
    prof.export(path)
    try:
        t = read_trace(path)
    finally:
        os.remove(path)
    # the first request pays the profiler's own set-up: leave it out
    reqs = sorted((a, b) for n, a, b in t["spans"] if n == "request")[1:]
    if not reqs:
        return None
    w0, w1 = min(a for a, _ in reqs), max(b for _, b in reqs)
    device = [(n, a, b) for n, a, b in t["device"] if a < w1 and b > w0]
    spans = [s for s in t["spans"] if s[1] >= w0 and s[2] <= w1]
    return TraceData((w0, w1), device, spans, len(reqs))


def breakdown(td: TraceData) -> dict:
    """The device operations that took most time, and the longest idle
    gaps labelled with the harness span the host was in."""
    by_op: Dict[str, float] = {}
    for name, a, b in td.device:
        by_op[name] = by_op.get(name, 0.0) + (min(b, td.window[1]) - max(a, td.window[0])) / 1e6
    busy = stats.union([(a, b) for _, a, b in td.device], *td.window)
    gaps = sorted(stats.gaps(busy, *td.window), key=lambda g: g[0] - g[1])[:BREAKDOWN]
    return {
        "device_ops": [[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])][:BREAKDOWN],
        "idle_gaps": [[span_at(td.spans, (a + b) / 2) or "between requests", (b - a) / 1e6]
                      for a, b in gaps],
    }
