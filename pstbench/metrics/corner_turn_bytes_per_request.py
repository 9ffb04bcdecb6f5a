"""Bytes the program's cascades copied in their corner turns (the growth
of its ``corner_turn_bytes`` counter over the traced stretch,
Run.counters) over the requests of that stretch. None where the program
has no such counter."""

from pstbench import program


def read(run):
    prof = program._stretch()
    if run.counters is None or "corner_turn_bytes" not in run.counters or prof is None:
        return None
    return run.counters["corner_turn_bytes"] / (prof.last - prof.first)
