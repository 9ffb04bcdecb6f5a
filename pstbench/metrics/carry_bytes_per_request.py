"""Bytes the streaming stages' carries wrote (the program's ``carry_bytes``
counter, pstbench.program) over every request the run handed over: the
warm-up, the profiler's first request and the window."""

from pstbench import program


def read(run):
    c = program.counters()
    if c is None or "carry_bytes" not in c:
        return None
    return c["carry_bytes"] / (int(run.traffic["warm_requests"]) + 1 + len(run.latencies))
