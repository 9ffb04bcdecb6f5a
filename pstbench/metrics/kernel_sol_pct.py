"""The kind's least time on this card (Traffic.least_seconds, by
pstbench.roofline's rule; for the round trip the FFT-optimal flops over the
fp32 peak, or 16 bytes a sample over the HBM peak, the larger) over the
device time of all its operations, per traced request, in percent."""


def read(run):
    t = run.trace
    if t is None or not t.device or not t.requests:
        return None
    least = run.least_seconds(run.samples_per_request * t.requests)
    if least is None:
        return None
    busy_s = sum(b - a for _, a, b in t.device) / 1e6
    return 100.0 * least / busy_s
