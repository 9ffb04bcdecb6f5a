"""Orchestration layer (reference python/data_gen equivalent; the port's
counterpart of :mod:`ska_pst_dsp_tpu.data_gen`): test-vector generation,
file-level channelize/synthesize on the CUDA kernels, pipeline composition,
external tool wrappers, cleanup."""

from . import config, util, dspsr_util  # noqa: F401
from .generate_test_vector import (  # noqa: F401
    generate_test_vector, complex_sinusoid, time_domain_impulse, noise,
)
from .channelize import channelize  # noqa: F401
from .synthesize import synthesize  # noqa: F401
from .pipeline import pipeline  # noqa: F401
from .dispose import dispose  # noqa: F401
from .dspsr_util import run_dspsr, run_dspsr_with_dump  # noqa: F401
