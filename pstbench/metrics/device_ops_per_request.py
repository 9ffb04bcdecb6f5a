"""Operations on the device (kernels, copies, sets) that the profiler
records in the traced stretch, per traced request."""


def read(run):
    t = run.trace
    if t is None or not t.device or not t.requests:
        return None
    return len(t.device) / t.requests
