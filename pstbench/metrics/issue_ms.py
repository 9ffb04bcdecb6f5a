"""Median host time of the call into the chain or the stream (the
``issue`` span: hand-off until the call returns, before the synchronise)
over the traced requests, in milliseconds."""

import statistics


def read(run):
    t = run.trace
    spans = [] if t is None else [b - a for n, a, b in t.spans if n == "issue"]
    return statistics.median(spans) / 1e3 if spans else None
