"""The ``lowpst.dedisp`` cell, which came in as new files: its names, its
kind's work count, the reference's discard, a sound run, a traced one, and
runs with the wrong chirp planted.

The runs are on the CPU (the program's plain versions) on three of the
configuration's 256 coarse channels (:func:`pst_small`); the slabs keep
their published widths."""

import json

import numpy as np
import pytest
import torch

from pstbench import design, generator, roofline, run

from .conftest import copy_data

PST_CELL = "lowpst.dedisp"
SEED = 2**31 + 2323
#: the SKA-Low PST node's cell on three of its 256 coarse channels, in
#: blocks of its own 1,600 fine samples, which the CPU runs in a tenth of a
#: second a request
PST_COARSE = 3
PST_SMALL = {"kind": "pst", "n_pol": 2, "block": 1600, "buffer_samples": 4800,
             "blocks_per_sample": 2, "warm_requests": 2}


@pytest.fixture
def pst_small(tmp_path, monkeypatch):
    """BENCHMARK.json, run from a copy of the harness's data folders whose
    lowpst.json has PST_COARSE coarse channels."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    here = tmp_path / "pstbench"
    copy_data(here)
    cfg = run.load_json(run.HERE / "configs" / "lowpst.json")
    (here / "configs" / "lowpst.json").write_text(json.dumps({**cfg,
                                                              "coarse_channels": PST_COARSE}))
    monkeypatch.setattr(run, "HERE", here)
    monkeypatch.setattr(run, "ROOT", tmp_path)
    return bench


def _run(bench, seconds=0.3, trace=False, patch=None):
    return run.run(bench, PST_CELL, SEED, seconds, trace, device="cpu",
                   traffic_params=PST_SMALL, patch=patch)


def test_the_pst_node_is_found_by_its_names():
    """The SKA-Low PST node's configuration, its kind and that kind's
    reference, its limits and its metric, each found by its name."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.by_name(bench["workloads"], PST_CELL, "workload")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("lowpst", "pst_1600", 1)
    entry = run.by_name(bench["configs"], "lowpst", "config")
    cfg = run.load_json(run.ROOT / entry["file"])
    assert cfg["name"] == "lowpst" and cfg["reduced"] == entry["reduced"] == []
    assert design.prototype_filter(cfg).shape == (3072,)
    params = run.load_json(run.HERE / "traffic" / "pst_1600.json")
    kind = generator.kind(params["kind"])
    assert params["kind"] == "pst" and kind.__module__ == "pstbench_kinds_pst"
    assert issubclass(kind, generator.Traffic)
    ref = generator.load("references", "pst")
    assert ref.__name__ == "pstbench_references_pst" and callable(ref.Pst)
    assert run.load_json(run.HERE / "limits" / f"{PST_CELL}.json")["max_rel_err"]["limit"] == 1e-4
    new = ["pst_inversion_sol_pct"]
    assert [m["name"] for m in run.cell_metrics(bench, PST_CELL, True)] == new
    for name in new:
        assert callable(run.load_module(run.HERE / "metrics" / f"{name}.py").read)
        assert run.by_name(bench["per_layer"], name, "metric")["workloads"] == [PST_CELL]
    e2e = {m["name"] for m in run.cell_metrics(bench, PST_CELL, False)}
    assert e2e == {"throughput_msps", "latency_p95_ms", "setup_s"}


def test_the_kind_counts_its_work_by_the_rule():
    """A request's 2 pol x 256 x 216 channels of 1,600 samples: 12.5
    inversion hops of each slab's 216 x 128 samples (each frame discards the
    taper's 48 and the chirp's reach, 64 a side), each block's FFT-optimal
    flops and the chirp's product; 8 B a sample in and 8 B a sample out
    (20,736 out a block): bound by bytes, ~0.74 ms on the H100."""
    cfg = run.load_json(run.HERE / "configs" / "lowpst.json")
    params = run.load_json(run.HERE / "traffic" / "pst_1600.json")
    kind = generator.kind("pst")(params, cfg, design.prototype_filter(cfg), 1, "cpu")
    assert (kind.slab.overlap, kind.slab.keep, kind.slab.out_keep) == (64, 128, 20736)
    n = 2 * 256 * 216 * 1600
    blocks = n / (216 * 128)
    fft = roofline.fft_flops
    flops = blocks * (216 * fft(256) + 6 * 216 * 192 + fft(41472) + 6 * 41472)
    hbm, fp32 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    least = kind.least_seconds(n, "NVIDIA H100 80GB HBM3")
    assert blocks == 512 * 12.5
    assert least == pytest.approx(max(flops / fp32, 8 * (n + blocks * 20736) / hbm), rel=1e-12)
    assert least == pytest.approx(8 * (n + blocks * 20736) / hbm) and 0.73e-3 < least < 0.75e-3
    assert kind.least_seconds(n, "no such card") is None


def test_the_reference_discards_the_taper_and_the_reach():
    """The reference's discard (dspsr's taper plus response): lowpsi's 48
    and 13 fine samples of 162 output samples for the 1,992-sample reach at
    150 MHz, rounded up to a multiple of nu = 4; the taper stays at 48."""
    cfg = run.load_json(run.HERE / "configs" / "lowpst.json")
    ref = generator.load("references", "pst")
    assert ref.reach(cfg["dm"], 150.0, 0.78125) == pytest.approx(1992.39, abs=0.01)
    assert ref.overlap(cfg) == 64 and ref.overlap({**cfg, "dm": 0.0}) == 48
    node = ref.Pst({**cfg, "coarse_channels": 1}, design.prototype_filter(cfg), "cpu")
    assert (node.g.overlap, node.g.out_overlap) == (64, 10368)
    taper = node.inverse.taper
    assert float(taper[47]) < 1.0 and bool((taper[48:208] == 1.0).all())


def test_a_sound_run_is_correct(pst_small):
    res = _run(pst_small)
    assert res["correct"], res["checks"]
    assert res["checks"]["max_rel_err"]["value"] < 1e-6
    assert set(res["metrics"]) == {"throughput_msps", "latency_p95_ms", "setup_s"}


def test_a_traced_run_on_the_cpu_reads_no_kernel(pst_small):
    """On the CPU the trace holds no kernel, so the kernel's share reads
    nothing and the line leaves it out."""
    res = _run(pst_small, seconds=3.0, trace=True)
    assert res["correct"] and res["metrics"] == {}
    assert torch.autograd._profiler_enabled() is False


def _after_setup(traffic, fn):
    setup = traffic.setup

    def patched():
        setup()
        fn(traffic)

    traffic.setup = patched


class _Chirps:
    """A dedispersion whose chirp table is ``table(d, n, channels,
    centred)`` of the sound one, d; the discard stays d's."""

    def __init__(self, d, table):
        self.d, self._table = d, table

    def __getattr__(self, name):
        return getattr(self.d, name)

    def table(self, n, channels, centred=False):
        return self._table(self.d, n, channels, centred)


def chirp_of(fault):
    """The PST node with its chirp table made by ``fault``."""
    def patch(traffic):
        def fn(t):
            t.inv.dedispersion = _Chirps(t.inv.dedispersion, fault)
        _after_setup(traffic, fn)
    return patch


def _pst_faults():
    from ska_pst_dsp_tpu_torch.ops.dedispersion import Dedispersion

    return {
        "sound": None,
        "chirp left out": chirp_of(lambda d, n, ch, c: np.ones((ch, n), np.complex64)),
        "the next coarse channel's": chirp_of(lambda d, n, ch, c: Dedispersion(
            d.dm, d.first_centre_mhz + d.coarse_bw_mhz, d.coarse_bw_mhz).table(n, ch, c)),
        "conjugate (dispersing)": chirp_of(lambda d, n, ch, c: d.table(n, ch, c).conj()),
        "on DC-first bins": chirp_of(lambda d, n, ch, c: d.table(n, ch)),
    }


@pytest.mark.parametrize("fault", ["sound", "chirp left out", "the next coarse channel's",
                                   "conjugate (dispersing)", "on DC-first bins"])
def test_a_pst_node_with_the_wrong_chirp_is_not_correct(pst_small, fault):
    """The PST node's cell on three coarse channels: sound, it is correct;
    with its chirps left out, shifted by one coarse channel, conjugated or
    on the DC-first order of the bins (the inversion's spectrum holds the
    channel's centre at bin N/2), it reads over the limit."""
    res = run.run(pst_small, PST_CELL, 2**31 + 99, 0.3, False, device="cpu",
                  traffic_params=PST_SMALL, patch=_pst_faults()[fault])
    check = res["checks"]["max_rel_err"]
    assert res["correct"] is (fault == "sound"), check
    assert (check["value"] < 1e-6) if fault == "sound" else (check["value"] > check["limit"])
