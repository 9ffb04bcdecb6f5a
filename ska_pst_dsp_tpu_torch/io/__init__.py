"""DADA file I/O (copy of the JAX package's ``io.dada`` generic path), the
LowCBF heap layout and the firmware-testbench conversion."""

from . import dada, lowcbf  # noqa: F401
from .dada import DADAFile, load, save  # noqa: F401
