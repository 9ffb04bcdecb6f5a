"""Command-line drivers of the port (the counterparts of
:mod:`ska_pst_dsp_tpu.cli`, reference L4 equivalents): sgcht, test_vector,
phrap, current_performance, test_sgcht, at3, plus the data_gen module mains
(channelize/synthesize). All but test_vector (host numpy) run on the card
unless given ``--device cpu``."""
