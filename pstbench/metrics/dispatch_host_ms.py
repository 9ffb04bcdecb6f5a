"""Median over the traced requests of the host time of the program's
``dispatch`` spans in a request (the epilogue's choice of route, before
the chosen epilogue is called; pstbench.program), in milliseconds."""

from pstbench import program


def read(run):
    return program.median_ms(run, lambda r: sum(b - a for a, b in r.get("dispatch", [])))
