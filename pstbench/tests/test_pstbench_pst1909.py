"""The ``lowpst1909.dedisp`` cell, which came in as new files: its names,
its kind's work count at L 512, the reference's discard at J1909-3744's DM,
a sound run, a traced one with its counters' ratio, and runs with the
wrong chirp planted.

The runs are on the CPU (the program's plain versions) on three of the
configuration's 256 coarse channels (:func:`pst1909_small`); the slabs keep
their published widths and the 512-sample frame."""

import json

import pytest

from pstbench import design, generator, roofline, run

from .conftest import copy_data
from .test_pstbench_pst import PST_COARSE, PST_SMALL, _pst_faults

CELL = "lowpst1909.dedisp"
SEED = 2**31 + 1909
NEW = ["pst_l512_inversion_sol_pct", "transform_points_per_output"]


@pytest.fixture
def pst1909_small(tmp_path, monkeypatch):
    """BENCHMARK.json, run from a copy of the harness's data folders whose
    lowpst1909.json has PST_COARSE coarse channels."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    here = tmp_path / "pstbench"
    copy_data(here)
    cfg = run.load_json(run.HERE / "configs" / "lowpst1909.json")
    (here / "configs" / "lowpst1909.json").write_text(
        json.dumps({**cfg, "coarse_channels": PST_COARSE}))
    monkeypatch.setattr(run, "HERE", here)
    monkeypatch.setattr(run, "ROOT", tmp_path)
    return bench


def _run(bench, seconds=0.3, trace=False, patch=None, seed=SEED):
    return run.run(bench, CELL, seed, seconds, trace, device="cpu", traffic_params=PST_SMALL,
                   patch=patch)


def test_the_cell_is_found_by_its_names():
    """The configuration (lowpst's keys at L 512 and J1909-3744's DM and
    period), the traffic lowpst.dedisp runs, the limits and the two new
    metrics, each found by its name."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.by_name(bench["workloads"], CELL, "workload")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("lowpst1909", "pst_1600", 1)
    entry = run.by_name(bench["configs"], "lowpst1909", "config")
    cfg = run.load_json(run.ROOT / entry["file"])
    base = run.load_json(run.HERE / "configs" / "lowpst.json")
    assert cfg["name"] == "lowpst1909" and cfg["reduced"] == entry["reduced"] == []
    assert cfg["source"] == entry["source"]
    changed = {k for k in base if base[k] != cfg.get(k)}
    assert changed == {"name", "source", "input_fft_length", "dm", "period", "smear_samples",
                       "assumed"}
    assert (cfg["input_fft_length"], cfg["dm"], cfg["period"]) == (512, 10.3919, 0.002947108)
    assert design.prototype_filter(cfg).shape == (3072,)
    assert generator.kind("pst").__module__ == "pstbench_kinds_pst"
    assert run.load_json(run.HERE / "limits" / f"{CELL}.json")["max_rel_err"]["limit"] == 1e-4
    assert [m["name"] for m in run.cell_metrics(bench, CELL, True)] == NEW
    for name in NEW:
        assert callable(run.load_module(run.HERE / "metrics" / f"{name}.py").read)
        assert run.by_name(bench["per_layer"], name, "metric")["workloads"] == [CELL]
    e2e = {m["name"] for m in run.cell_metrics(bench, CELL, False)}
    assert e2e == {"throughput_msps", "latency_p95_ms", "setup_s"}


def test_the_kind_counts_its_work_at_l512():
    """A request's 2 pol x 256 x 216 channels of 1,600 samples: 5.13
    inversion hops of each slab's 216 x 312 samples (each 512-sample frame
    discards the taper's 48 and the chirp's reach, 100 a side), each
    82,944-point block's FFT-optimal flops and the chirp's product; 8 B a
    sample in and 8 B a sample out (50,544 out a block): bound by bytes,
    the same ~0.74 ms on the H100 as lowpst.dedisp, the output being 3/4 of
    the input at any frame length."""
    cfg = run.load_json(run.HERE / "configs" / "lowpst1909.json")
    params = run.load_json(run.HERE / "traffic" / "pst_1600.json")
    kind = generator.kind("pst")(params, cfg, design.prototype_filter(cfg), 1, "cpu")
    s = kind.slab
    assert (s.L, s.overlap, s.keep, s.out_keep, s.n_out_fft) == (512, 100, 312, 50544, 82944)
    n = 2 * 256 * 216 * 1600
    blocks = n / (216 * 312)
    fft = roofline.fft_flops
    flops = blocks * (216 * fft(512) + 6 * 216 * 384 + fft(82944) + 6 * 82944)
    hbm, fp32 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    least = kind.least_seconds(n, "NVIDIA H100 80GB HBM3")
    assert blocks == pytest.approx(512 * 1600 / 312)
    assert least == pytest.approx(max(flops / fp32, 8 * (n + blocks * 50544) / hbm), rel=1e-12)
    assert least == pytest.approx(8 * (n + blocks * 50544) / hbm) and 0.73e-3 < least < 0.75e-3


def test_the_reference_discards_the_taper_and_the_reach_at_l512():
    """The reference's discard at J1909-3744's DM: lowpsi's 48 and 49 fine
    samples of 162 output samples for the 7,829-sample reach at 150 MHz,
    rounded up to a multiple of nu = 4: 100, 16,200 output samples."""
    cfg = run.load_json(run.HERE / "configs" / "lowpst1909.json")
    ref = generator.load("references", "pst")
    assert ref.reach(cfg["dm"], 150.0, 0.78125) == pytest.approx(7828.58, abs=0.01)
    assert ref.overlap(cfg) == 100
    node = ref.Pst({**cfg, "coarse_channels": 1}, design.prototype_filter(cfg), "cpu")
    assert (node.g.L, node.g.overlap, node.g.out_overlap) == (512, 100, 16200)
    taper = node.inverse.taper
    assert float(taper[47]) < 1.0 and bool((taper[48:464] == 1.0).all())


def test_a_sound_run_is_correct(pst1909_small):
    res = _run(pst1909_small)
    assert res["correct"], res["checks"]
    assert res["checks"]["max_rel_err"]["value"] < 1e-6
    assert set(res["metrics"]) == {"throughput_msps", "latency_p95_ms", "setup_s"}


def test_a_traced_run_reads_the_frame_lengths_cost(pst1909_small):
    """On the CPU the trace holds no kernel, so the plan's share reads
    nothing; the program's counters read 82,944 transform points for each
    50,544 output samples kept."""
    res = _run(pst1909_small, seconds=3.0, trace=True)
    assert res["correct"] and set(res["metrics"]) == {"transform_points_per_output"}
    ratio = res["metrics"]["transform_points_per_output"]
    assert ratio["value"] == pytest.approx(82944 / 50544) and ratio["unit"] == "ratio"


@pytest.mark.parametrize("fault", ["sound", "chirp left out", "the next coarse channel's",
                                   "conjugate (dispersing)", "on DC-first bins"])
def test_a_node_at_l512_with_the_wrong_chirp_is_not_correct(pst1909_small, fault):
    """The cell on three coarse channels: sound, it is correct; with its
    chirps left out, shifted by one coarse channel, conjugated or on the
    DC-first order of the bins, it reads over the limit."""
    res = _run(pst1909_small, patch=_pst_faults()[fault], seed=2**31 + 77)
    check = res["checks"]["max_rel_err"]
    assert res["correct"] is (fault == "sound"), check
    assert (check["value"] < 1e-6) if fault == "sound" else (check["value"] > check["limit"])
