"""Share of the traced stretch in which no operation runs on the device
(the union of the profiler's device intervals), in percent."""

from pstbench import stats


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    w0, w1 = t.window
    busy = sum(b - a for a, b in stats.union([(a, b) for _, a, b in t.device], w0, w1))
    return 100.0 * (1.0 - busy / (w1 - w0))
