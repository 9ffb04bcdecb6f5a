"""Process start to the first timed request: imports, the card, the kernel
library, the filter design, the program's modules, the inputs, the warm-up."""


def read(run):
    return run.setup_s
