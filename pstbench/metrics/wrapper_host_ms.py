"""Median over the traced requests of the host time the program's wrappers
layer covers in a request: the union of its ``kernel.*``, ``inversion``
and ``dispatch`` spans (pstbench.program), in milliseconds."""

from pstbench import program


def read(run):
    return program.median_ms(run, lambda r: program.length(program.wrapper_spans(r)))
