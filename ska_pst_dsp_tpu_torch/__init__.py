"""PyTorch/CUDA port of the oversampled PFB analysis + Golden inversion.

A second package beside :mod:`ska_pst_dsp_tpu` (the JAX reference). Module
names mirror the JAX package so each counterpart is easy to find; the data
are ``torch.complex64`` tensors on an explicit device, and the fused kernels
of the SKA-Low and SKA-Mid round trips are hand-written CUDA C++ for Hopper
(``csrc/``, built on first use by :mod:`.ops.kernels._build`).

The JAX package's host-only modules (``utils``, ``design.fir``, ``io.dada``,
``oracle``, ``verify.util``) import no JAX and are reused from there; this
package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from ska_pst_dsp_tpu.utils.config import load_config  # noqa: F401
from ska_pst_dsp_tpu.utils.rational import Rational  # noqa: F401
