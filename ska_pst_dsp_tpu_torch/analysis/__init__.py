"""Analysis helpers of the port (counterparts of :mod:`ska_pst_dsp_tpu.analysis`)."""
