"""The 95th percentile of every request's latency in the window, hand-off
to output complete on the card, in milliseconds."""

from pstbench import stats


def read(run):
    return stats.percentile(run.latencies, 95) * 1e3
