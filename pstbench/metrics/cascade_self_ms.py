"""Median over the traced requests of the host time of the program's
cascade spans (``two_stage.filterbank``, ``two_stage.inverse_filterbank``)
in a request less the part that its stages' spans (``filterbank``,
``inverse_filterbank``) cover: the cascade's own work, its ``corner_turn``
spans among it (pstbench.program), in milliseconds. None where the
program has no cascade spans."""

from pstbench import program, stats

CASCADE = ("two_stage.filterbank", "two_stage.inverse_filterbank")
STAGES = ("filterbank", "inverse_filterbank")


def cascade_self(req):
    top = stats.union([iv for name in CASCADE for iv in req.get(name, [])],
                      -float("inf"), float("inf"))
    inner = [(max(a, c), min(b, d)) for a, b in top
             for name in STAGES for c, d in req.get(name, [])]
    return program.length(top) - program.length([iv for iv in inner if iv[1] > iv[0]])


def read(run):
    reqs = program.requests(run)
    if reqs is None or not any(name in r for r in reqs for name in CASCADE):
        return None
    return program.median_ms(run, cascade_self)
