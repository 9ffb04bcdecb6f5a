"""The kind's least time (Traffic.least_seconds, by pstbench.roofline's
rule) over the device time of the traced stretch's records of the
program's fused inversion, ``inversion_fused_kernel``, per traced request,
in percent: the share of the node's roofline that the inversion's plan at
L = 512 reaches, in the cell where only that plan runs. None where the
trace holds no such record (a program without that plan runs other
kernels there)."""

KERNEL = "inversion_fused_kernel"


def read(run):
    t = run.trace
    if t is None or not t.requests:
        return None
    busy_s = sum(b - a for name, a, b in t.device if name == KERNEL) / 1e6
    least = run.least_seconds(run.samples_per_request * t.requests)
    if least is None or busy_s <= 0:
        return None
    return 100.0 * least / busy_s
