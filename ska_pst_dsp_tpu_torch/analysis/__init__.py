"""Analysis helpers of the port (counterparts of :mod:`ska_pst_dsp_tpu.analysis`)."""

from . import plots, compare_dump_files  # noqa: F401
