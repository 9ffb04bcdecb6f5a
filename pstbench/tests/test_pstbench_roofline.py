"""The roofline count against hand figures."""

import pytest

from pstbench import reference, roofline, run


def _geometry(name):
    return reference.geometry(run.load_json(run.HERE / "configs" / f"{name}.json"))


@pytest.mark.parametrize("name, flops", [("low", 342.3), ("mid", 505.8)])
def test_fft_optimal_flops_per_sample(name, flops):
    assert roofline.flops_per_sample(_geometry(name)) == pytest.approx(flops, abs=0.05)


def test_bytes_are_the_work_not_the_kernels():
    assert roofline.BYTES_PER_SAMPLE == 16


@pytest.mark.parametrize("name, samples, ms", [("low", 2 * 2**23, 0.08571),
                                                ("mid", 2 * 4587520, 0.06926)])
def test_least_time_is_fp32_bound_on_the_h100(name, samples, ms):
    g = _geometry(name)
    t = roofline.least_seconds(g, samples, "NVIDIA H100 80GB HBM3")
    assert t * 1e3 == pytest.approx(ms, rel=1e-3)
    assert t == pytest.approx(roofline.flops_per_sample(g) * samples / 67e12)
    assert t > 16 * samples / 3.35e12


def test_unknown_card_has_no_roofline():
    assert roofline.least_seconds(_geometry("low"), 1, "cpu") is None
