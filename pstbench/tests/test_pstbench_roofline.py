"""The roofline count against hand figures, and the kernel roofline's
reader against the formula it read before each kind counted its own work."""

import functools
import math

import pytest

from pstbench import generator, reference, roofline, run
from pstbench.trace import TraceData

H100 = "NVIDIA H100 80GB HBM3"


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


def _old_kernel_sol_pct(cfg, samples_per_request, td):
    """kernel_sol_pct as the reader computed it before: the round trip's
    count from the configuration's geometry, written out whole."""
    g = reference.geometry(cfg)

    def fft(n):
        return 5.0 * n * math.log2(n)

    per_sample = ((4.0 * g.fl + fft(g.n_chan)) / g.step
                  + (g.n_chan * fft(g.L) + 6.0 * g.n_chan * g.fn_width + fft(g.n_out_fft))
                  / g.out_keep)
    samples = samples_per_request * td.requests
    least = max(per_sample * samples / 67e12, 16 * samples / 3.35e12)
    return 100.0 * least / (sum(b - a for _, a, b in td.device) / 1e6)


@pytest.mark.parametrize("name, mix", [("low", "oneshot_8mi"), ("mid", "oneshot_4480ki"),
                                       ("low", "stream_64ki")])
def test_kernel_sol_pct_reads_as_before(name, mix):
    cfg = run.load_json(run.HERE / "configs" / f"{name}.json")
    params = run.load_json(run.HERE / "traffic" / f"{mix}.json")
    traffic = generator.make(params, cfg, None, 1, "cpu")
    spr = params["n_pol"] * params.get("samples", params.get("block"))
    td = TraceData((0.0, 5000.0), [("k", 10.0, 1234.5), ("m", 1300.25, 4321.0)], [], 7)
    record = run.Run(cfg, params, spr, 0, [1e-3], 1.0, 1.0, H100,
                     functools.partial(traffic.least_seconds, device_name=H100), td)
    got = run.load_module(run.HERE / "metrics" / "kernel_sol_pct.py").read(record)
    assert got == _old_kernel_sol_pct(cfg, spr, td)
