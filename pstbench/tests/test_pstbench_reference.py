"""The plain reference against the program's plain chain at small sizes.

Only this test imports the program beside the reference: the reference
itself imports nothing of it (test_pstbench_imports.py)."""

import numpy as np
import pytest
import torch

from pstbench import design, generator, reference, run
from pstbench.trace import Tracer

from .conftest import NARROW_MID

#: the program's float32 plain chain against the float64 reference
TOL = 1e-6


def _low():
    return run.load_json(run.HERE / "configs" / "low.json")


def _noise(n, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(2, n, generator=g), torch.randn(2, n, generator=g))


def _err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("cfg_name", ["low", "midn"])
def test_designs_are_the_programs(cfg_name):
    from ska_pst_dsp_tpu_torch.design import fir
    from ska_pst_dsp_tpu_torch.utils.rational import Rational

    cfg = _low() if cfg_name == "low" else NARROW_MID
    h = design.prototype_filter(cfg)
    nu, de = design.os_parts(cfg)
    if cfg_name == "low":
        want = fir.design_pfb_fir_filter(256, Rational(nu, de), 12)
    else:
        want = fir.design_pfb_fir_filter_two_stage(256, Rational(nu, de), 28)
    assert np.array_equal(h, want)
    assert np.allclose(design.deripple(h, 256, 96 if cfg_name == "low" else 28),
                       fir.deripple_response(h, 256, 96 if cfg_name == "low" else 28))


@pytest.mark.parametrize("cfg_name, n", [("low", 2**17), ("midn", 224 * 64 * 6)])
def test_round_trip_matches_the_programs_plain_chain(cfg_name, n):
    from ska_pst_dsp_tpu_torch.models.round_trip import PaddedPFBRoundTrip, PFBRoundTrip

    cfg = _low() if cfg_name == "low" else NARROW_MID
    h = design.prototype_filter(cfg)
    cls = PaddedPFBRoundTrip if cfg_name == "midn" else PFBRoundTrip
    m = cls.from_filter(h, cfg["channels"], cfg["os_factor"], cfg["input_fft_length"],
                        cfg["input_overlap"], device="cpu", temporal_taper="tukey")
    x = _noise(n)
    want = reference.Reference(cfg, h, "cpu").round_trip(x)
    got = m.reference(x)[:, 0]
    assert got.shape == want.shape == (2, reference.geometry(cfg).out_len(n))
    assert _err(got, want) < TOL


def test_control_reads_far_above_the_program():
    cfg = _low()
    h = design.prototype_filter(cfg)
    x = _noise(2**17)
    exact = reference.Reference(cfg, h, "cpu").round_trip(x)
    assert _err(reference.Reference(cfg, h, "cpu", "fp32").round_trip(x), exact) < TOL
    assert _err(reference.Reference(cfg, h, "cpu", "bf16").round_trip(x), exact) > 1e-3


@pytest.mark.parametrize("cfg_name, block", [("low", 65536), ("midn", 224 * 64)])
def test_streamed_output_is_placed_where_the_reference_puts_it(cfg_name, block):
    """Kept runs of the program's streamed output, anywhere in a stream
    that wraps its buffer, equal the reference's one-shot of the aligned
    stretch of input (the padded analysis begun early enough)."""
    cfg = _low() if cfg_name == "low" else NARROW_MID
    h = design.prototype_filter(cfg)
    params = {"kind": "stream", "n_pol": 2, "block": block, "buffer_samples": 8 * block,
              "blocks_per_sample": 3, "warm_requests": 0}
    t = generator.make(params, cfg, h, 5, "cpu")
    t.setup()
    keeper = run.Keeper(5, t.group, slots=5)
    tr = Tracer(False)
    for i in range(40):
        keeper.offer(i, t.record(i, t.request(i, tr)))
    pairs = t.pairs([r for s in keeper.kept for r in s], reference.Reference(cfg, h, "cpu"))
    assert len(pairs) >= 3
    assert all(g.shape[-1] > 0 for g, _ in pairs)
    assert max(run.rel_err(g, w) for g, w in pairs) < TOL
