"""Median over the traced requests of the host time of the program's
``composed_epilogue`` spans in a request (the inversion's epilogue run
composed, where no kernel's plan covers the block's length;
pstbench.program), in milliseconds. None where the program has no such
span."""

from pstbench import program


def read(run):
    reqs = program.requests(run)
    if reqs is None or not any("composed_epilogue" in r for r in reqs):
        return None
    return program.median_ms(run, lambda r: sum(b - a for a, b in r.get("composed_epilogue", [])))
