"""The benchmark of the PyTorch/CUDA port (``ska_pst_dsp_tpu_torch``):
``python -m pstbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``."""
