"""The kind's least time on this card over a million complex input
samples (Run.least_seconds), in ms."""


def read(run):
    least = run.least_seconds(10**6)
    return None if least is None else least * 1e3
