"""Complex input samples (all polarisations) of every request completed in
the window, over the window's seconds, in millions a second."""

from pstbench import stats


def read(run):
    return stats.rate(run.samples_per_request * len(run.latencies), run.window_s) / 1e6
