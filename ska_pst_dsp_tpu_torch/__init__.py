"""PyTorch/CUDA port of the oversampled PFB analysis + Golden inversion.

A second package beside :mod:`ska_pst_dsp_tpu` (the JAX reference). Module
names mirror the JAX package so each counterpart is easy to find; the data
are ``torch.complex64`` tensors on an explicit device, and the fused kernels
of the SKA-Low and SKA-Mid round trips are hand-written CUDA C++ for Hopper
(``csrc/``, built on first use by :mod:`.ops.kernels._build`).

The host modules it needs (``utils``, ``design.fir``, ``io.dada``,
``oracle``, ``verify.util``) are its own copies of the JAX package's, under
the same names. This package imports ``torch`` and numpy/scipy, and nothing
of ``jax`` or of :mod:`ska_pst_dsp_tpu`.
"""

__version__ = "0.1.0"

from .utils.config import load_config  # noqa: F401
from .utils.rational import Rational  # noqa: F401
