"""Verification harness (the port's counterpart of :mod:`ska_pst_dsp_tpu.verify`)."""

from . import comparator, common, util  # noqa: F401
