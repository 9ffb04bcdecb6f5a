"""SKA-Low's PST cascade on the CPU against the benchmark's float64 reference.

The port's ``TwoStageFilterBank`` (sps: 256 channels at OS 32/27, 6145
taps, then the LowCBF firmware filterbank: 256 channels, 216 kept, 3072
taps at hop 192) and ``TwoStageInverseFilterBank`` (each coarse channel's
216 monotonic channels inverted, oversampled), as ``sgcht --two_stage
--invert`` builds them from ``test.config.json``, on seeded complex noise
at the published widths, against ``pstbench/references/cascade.py`` (plain
torch in float64, written from the Matlab and importing nothing of the
program) with the benchmark's own filter designs:

* one call, coarse channel 0 (``single=True``), over the shortest input
  that gives two inversion blocks;
* the same stream in three blocks, the states carried, over three;
* every coarse channel of both polarisations through stage 2, over the
  shortest input that gives LowCBF spectra.

The plain versions of the kernels run (the tensors lie on the CPU), in
float32 as on the card. Each tolerance is also held to the reference
computed in bfloat16, which has to fail it.
"""

import numpy as np
import pytest
import torch

from pstbench import design, run
from ska_pst_dsp_tpu_torch.models.two_stage import (
    TwoStageFilterBank, TwoStageInverseFilterBank,
)
from ska_pst_dsp_tpu_torch.utils.config import load_config

#: max |port - reference| / max |reference|. The port computes in float32
#: through a 256-point FFT in each analysis and the inversion's 256- and
#: 41,472-point transforms; it reads 2.1e-7 to 3.3e-7 here. Ten times the
#: largest reading; the reference in bfloat16 reads 4.8e-3 to 6.7e-3, over
#: a thousand times this.
TOL = 3e-6
#: sps's hop and padded filter length, LowCBF's hop, its first call's zero
#: pad and filter length, and the inversion's keep and overlap (spectra)
STEP1, FL1, STEP2, PAD2, NFILT2, KEEP, OVERLAP = 216, 6400, 192, 1536, 3072, 160, 48
#: output samples an inversion block keeps: 216 channels x 192 bins less
#: the two output overlaps of 48 * 3/4 * 216
OUT_KEEP = 216 * 192 - 2 * 7776
#: the stream's blocks: a call emits whole chunks of spectra (32 stage-1
#: spectra for OS 32/27, 4 of stage 2 for OS 4/3) and so holds some back
BLOCK = 2 ** 23


def n_input(inversion_blocks: int) -> int:
    """Samples a polarisation that give ``inversion_blocks`` blocks in one
    call: the stage-2 spectra they need, the stage-1 spectra that give
    those behind LowCBF's first-call pad, and the samples that give those."""
    spectra2 = inversion_blocks * KEEP + 2 * OVERLAP
    return (spectra2 * STEP2 + NFILT2 - PAD2) * STEP1 + FL1


def _noise(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(shape, generator=g), torch.randn(shape, generator=g))


def rel_err(got, want):
    assert got.shape[:-1] == want.shape[:-1] and 0 < got.shape[-1] <= want.shape[-1]
    want = want[..., :got.shape[-1]]
    return float((got.to(want.dtype) - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def configs():
    return load_config("sps"), load_config("lowpsi")


@pytest.fixture(scope="module")
def references():
    """precision -> the benchmark's reference of the lowpsi configuration,
    with the benchmark's filters."""
    cfg = run.load_json(run.HERE / "configs" / "lowpsi.json")
    mod = run.load_module(run.HERE / "references" / "cascade.py")
    filt, filt2 = design.prototype_filter(cfg), design.prototype_filter(cfg["stage2"])
    return {p: mod.Cascade(cfg, filt, filt2, "cpu", p) for p in ("fp64", "bf16")}


@pytest.fixture(scope="module")
def stream():
    """One polarisation of noise, three blocks long."""
    return _noise((1, 3 * BLOCK), 19)


@pytest.fixture(scope="module")
def stream_reference(references, stream):
    """Coarse channel 0 of the stream, reconstructed by the reference in
    float64 and in bfloat16."""
    return {p: ref.cascade(stream, coarse=1) for p, ref in references.items()}


def cascade(configs, **kw):
    sps, lowpsi = configs
    return (TwoStageFilterBank(sps, lowpsi, device="cpu", **kw),
            TwoStageInverseFilterBank(sps, lowpsi, nch2=lowpsi.kept_channels, device="cpu",
                                      **kw))


def test_the_port_and_the_reference_take_the_same_filters(configs, references):
    sps, lowpsi = configs
    ref = references["fp64"]
    assert np.array_equal(sps.load_fir_filter_coeff(), ref.stage1.filt[:6145].numpy())
    assert np.array_equal(lowpsi.load_fir_filter_coeff(), ref.taps.reshape(-1).numpy())


@pytest.mark.parametrize("blocks", [1, 3])
def test_single_coarse_channel_against_the_reference(configs, stream, stream_reference,
                                                     blocks):
    """Coarse channel 0 through both stages and its inversion: in one call
    over the shortest input with two inversion blocks, and the stream in
    three blocks with the states carried, which gives three."""
    fb, inv = cascade(configs, single=True)
    s_fb, s_inv = fb.init_state(), inv.init_state()
    x = stream[:, :n_input(2)] if blocks == 1 else stream
    size = -(-x.shape[-1] // blocks)
    outs = []
    for a in range(0, x.shape[-1], size):
        s_fb, y = fb.execute(s_fb, x[:, a:a + size])
        s_inv, z = inv.execute(s_inv, y)
        assert y.shape[:2] == (1, 216) and z.shape[:2] == (1, 1)
        outs.append(z)
    got = torch.cat(outs, dim=-1)
    assert got.shape[-1] == (2 if blocks == 1 else 3) * OUT_KEEP
    assert rel_err(got, stream_reference["fp64"]) < TOL
    assert rel_err(stream_reference["bf16"][..., :got.shape[-1]],
                   stream_reference["fp64"]) > 100 * TOL


def test_every_coarse_channel_through_stage_two(configs, references):
    """Both polarisations, all 256 coarse channels through the LowCBF stage
    (512 streams), over the shortest input that gives LowCBF spectra: its
    first call's pad and stage 2's chunk of 4 spectra."""
    fb, _ = cascade(configs)
    x = _noise((2, (4 * STEP2 + NFILT2 - PAD2) * STEP1 + FL1), 23)
    _, got = fb.execute(fb.init_state(), x)
    assert got.shape == (2, 256 * 216, 4)
    want = references["fp64"].analyses(x)
    assert rel_err(got, want) < TOL
    assert rel_err(references["bf16"].analyses(x), want) > 100 * TOL
