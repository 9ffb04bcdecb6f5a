"""Median over the traced requests of the host time of the program's chain
and stream spans (``forward``, ``filterbank``, ``inverse_filterbank``) in a
request less the part that the wrappers layer's spans cover; the ``carry``
spans count as the chain's own (pstbench.program), in milliseconds."""

from pstbench import program


def read(run):
    return program.median_ms(run, program.chain_self)
