"""The port's data_gen and sgcht on the card: the file-level low round trip
on the kernels against the plain versions on the card (8e-6 / 1.2e-5 x
scale), and one ``sgcht --invert --test`` at low with the plain versions
and torch.fft patched to raise. Marked ``cuda``: they skip without a card.
This module imports neither JAX nor the JAX package, so it runs on the card
with ``python -m pytest --noconftest tests/test_torch_cli_card.py -m cuda``.
"""

import pytest
import torch

from ska_pst_dsp_tpu_torch import data_gen
from ska_pst_dsp_tpu_torch.cli import sgcht
from ska_pst_dsp_tpu_torch.io import dada
from ska_pst_dsp_tpu_torch.ops import analysis, synthesis
from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import analysis_fused
from ska_pst_dsp_tpu_torch.ops.kernels.ifft_fused import fused_big_ifft
from ska_pst_dsp_tpu_torch.ops.kernels.inversion_fused import inversion_fused
from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import synthesis_fused
from ska_pst_dsp_tpu_torch.utils.config import load_config

ANALYSIS_TOL = 8e-6
SYNTHESIS_TOL = 1.2e-5
#: the low chain's kernels, and the two the fused inversion stands in for there
LOW_KERNELS = (analysis_fused, inversion_fused)
PAIR_KERNELS = (synthesis_fused, fused_big_ifft)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
def test_file_round_trip_low_on_kernels(cuda, tmp_path):
    cfg = load_config("low")
    filt = cfg.load_fir_filter_coeff()
    src = data_gen.generate_test_vector(domain_name="freq", n_bins=2 ** 20)(
        [0.26], [0.0], output_dir=str(tmp_path), n_pol=2)
    for k in LOW_KERNELS + PAIR_KERNELS:
        k.launches = 0
    chan = data_gen.channelize(src.file_path, channels=256, os_factor_str="4/3",
                               fir_filter_path=cfg.fir_filter_path, output_dir=str(tmp_path))
    synth = data_gen.synthesize(chan.file_path, input_fft_length=256, input_overlap=48,
                                output_dir=str(tmp_path))
    assert [k.launches for k in LOW_KERNELS + PAIR_KERNELS] == [1, 1, 0, 0]
    x = torch.as_tensor(dada.load(src.file_path)[0], device=cuda)
    plain_chan = analysis.polyphase_analysis(x, filt, 256, "4/3")
    plain = synthesis.polyphase_synthesis(
        torch.as_tensor(dada.load(chan.file_path)[0], device=cuda), 256, "4/3",
        input_overlap=48, deripple_coeff=dada.get_fir_filters_from_header(chan.header)[0][0],
        temporal_taper="tukey")
    assert _rel(torch.as_tensor(chan.data_pft, device=cuda), plain_chan) <= ANALYSIS_TOL
    assert _rel(torch.as_tensor(synth.data_pft, device=cuda), plain) <= SYNTHESIS_TOL


@pytest.mark.cuda
def test_sgcht_invert_test_low_without_fallback(cuda):
    import chip_smoke

    for k in LOW_KERNELS + PAIR_KERNELS:
        k.launches = 0
    with chip_smoke.plain_versions_raise(torch) as patched:
        rc = sgcht.run(["--signal", "complex_sinusoid", "--cfg", "low", "--invert", "--test",
                        "--blocks", "3", "--blocksz", "131072"])
    assert patched > 0 and rc == 0
    assert all(k.launches > 0 for k in LOW_KERNELS)
    assert not any(k.launches for k in PAIR_KERNELS)
