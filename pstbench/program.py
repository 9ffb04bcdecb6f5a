"""The program's own spans and counters, for the per-layer metrics that
look inside it.

The program marks its layer boundaries with ``pst:`` annotations while a
profiler records (``ska_pst_dsp_tpu_torch.utils.profiling``: ``forward``,
``filterbank``, ``inverse_filterbank`` and ``carry`` in the chain and
stream; ``kernel.<name>``, ``inversion`` and ``dispatch`` in the wrappers)
and keeps counters (``profiling.counters()``). A traced run profiles a
stretch of the window (:class:`pstbench.trace.Profile`); this module finds
that profile on the stack of the run that calls a metric's reader, reads
its events, and groups the program's spans by the harness's ``request``
span that holds them, leaving out the stretch's first request as
:func:`pstbench.trace.read_profile` does. Every function returns None (and
raises nothing) where the program has no spans or counters to read.
"""

from __future__ import annotations

import bisect
import statistics
import sys
import weakref
from typing import Dict, Iterable, List, Optional, Tuple

from . import stats, trace

#: the top spans of the chain and stream layer
CHAIN = ("forward", "filterbank", "inverse_filterbank")
#: spans of the wrappers layer besides the ``kernel.*`` ones
WRAPPERS = ("inversion", "dispatch")

_read: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

Interval = Tuple[float, float]


def profiling():
    """The program's ``utils.profiling`` module, or None."""
    try:
        from ska_pst_dsp_tpu_torch.utils import profiling as mod
    except ImportError:
        return None
    return mod


def prefix() -> Optional[str]:
    """The prefix of the program's annotations, read from the program."""
    return getattr(profiling(), "PREFIX", None)


def counters() -> Optional[Dict[str, int]]:
    """Every counter of the program (``profiling.counters()``), or None."""
    fn = getattr(profiling(), "counters", None)
    return None if fn is None else fn()


def _stretch() -> Optional[trace.Profile]:
    """The profiled stretch of the run whose reader is being called: the
    :class:`pstbench.trace.Profile` that a caller's frame holds."""
    frame = sys._getframe(1)
    while frame is not None:
        for value in list(frame.f_locals.values()):
            if isinstance(value, trace.Profile) and value.first is not None:
                return value
        frame = frame.f_back
    return None


def _events(prof: trace.Profile) -> List[Tuple[str, float, float]]:
    """(name, start_us, end_us) of every host event the profiler kept (an
    annotation also shows on the device's timeline, under the same name,
    where it holds kernels: those are left out)."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.prof.events()
            if e.device_type == DeviceType.CPU]


def spans_by_request(events: Iterable[Tuple[str, float, float]], pre: str
                     ) -> List[Dict[str, List[Interval]]]:
    """The program's spans (``pre`` + name) grouped by the harness's
    ``request`` span that holds their start, one dict a request (span name
    -> its intervals; the request itself under ``request``), the first
    request left out."""
    events = list(events)
    reqs = sorted((a, b) for n, a, b in events if n == trace.PREFIX + "request")[1:]
    out: List[Dict[str, List[Interval]]] = [{"request": [r]} for r in reqs]
    starts = [a for a, _ in reqs]
    for name, a, b in events:
        if not name.startswith(pre):
            continue
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and b <= reqs[k][1]:
            out[k].setdefault(name[len(pre):], []).append((a, b))
    return out


def requests(run) -> Optional[List[Dict[str, List[Interval]]]]:
    """:func:`spans_by_request` of the traced stretch of ``run``'s caller,
    or None where there is no stretch or the program left no span in it."""
    if run.trace is None:
        return None
    pre, prof = prefix(), _stretch()
    if pre is None or prof is None:
        return None
    if prof not in _read:
        _read[prof] = spans_by_request(_events(prof), pre)
    reqs = _read[prof]
    return reqs if any(len(r) > 1 for r in reqs) else None


def length(intervals: Iterable[Interval]) -> float:
    """The time the union of ``intervals`` covers."""
    return sum(b - a for a, b in stats.union(intervals, -float("inf"), float("inf")))


def wrapper_spans(req: Dict[str, List[Interval]]) -> List[Interval]:
    """The request's spans of the wrappers layer."""
    return [iv for name, ivs in req.items()
            if name.startswith("kernel.") or name in WRAPPERS for iv in ivs]


def chain_spans(req: Dict[str, List[Interval]]) -> List[Interval]:
    """The request's top spans of the chain and stream layer."""
    return [iv for name in CHAIN for iv in req.get(name, [])]


def chain_self(req: Dict[str, List[Interval]]) -> float:
    """The time of the chain's spans that no wrappers span covers (the
    ``carry`` spans count as the chain's own)."""
    top = stats.union(chain_spans(req), -float("inf"), float("inf"))
    inner = [(max(a, c), min(b, d)) for a, b in top for c, d in wrapper_spans(req)]
    return length(top) - length([iv for iv in inner if iv[1] > iv[0]])


def median_ms(run, per_request) -> Optional[float]:
    """The median over the traced requests of ``per_request(req)`` (us),
    in ms; None where the program left no span."""
    reqs = requests(run)
    if reqs is None:
        return None
    return statistics.median(per_request(r) for r in reqs) / 1e3


def idle_gaps(run, td: Optional[trace.TraceData] = None) -> Optional[List[list]]:
    """The longest idle gaps of the device, labelled as
    :func:`pstbench.trace.breakdown` labels them, and where a program span
    holds a gap's midpoint ``<harness span>/<innermost program span>``.
    The program's spans are moved onto the trace's clock by the start of
    the stretch's first kept request, which both clocks hold."""
    td = td or run.trace
    reqs = requests(run)
    if td is None or reqs is None:
        return None
    first = [a for n, a, _ in td.spans if n == "request"]
    if not first:
        return None
    shift = min(first) - reqs[0]["request"][0][0]
    program = [(name, a + shift, b + shift) for r in reqs for name, ivs in r.items()
               if name != "request" for a, b in ivs]
    busy = stats.union([(a, b) for _, a, b in td.device], *td.window)
    gaps = sorted(stats.gaps(busy, *td.window), key=lambda g: g[0] - g[1])[:trace.BREAKDOWN]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        outer = trace.span_at(td.spans, mid) or "between requests"
        inner = trace.span_at(program, mid)
        out.append([outer if inner is None else f"{outer}/{inner}", (b - a) / 1e6])
    return out
