"""The ``lowpsi.cascade`` cell, which came in as new files: its
configuration and taps, its kind, its plain reference and its three
per-layer metrics.

The runs are on the CPU (the program's plain versions) with the
configuration's stage 1 cut to 16 channels so that a block takes a tenth of
a second; stage 2 (the LowCBF firmware filterbank) and the inversion keep
their published widths."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pstbench import design, generator, roofline, run

from .conftest import copy_data

CELL = "lowpsi.cascade"
SEED = 2**31 + 1919
#: sgcht's two-stage traffic at a size the CPU runs in a second
SMALL = {"kind": "cascade", "n_pol": 2, "block": 2**19, "buffer_samples": 2**21,
         "blocks_per_sample": 2, "warm_requests": 3}
NEW = ("cascade_self_ms", "composed_epilogue_ms", "corner_turn_bytes_per_request")


def small_config() -> dict:
    """lowpsi.json with stage 1 at 16 channels, OS 4/3, 12 taps a channel."""
    cfg = run.load_json(run.HERE / "configs" / "lowpsi.json")
    cfg.update(channels=16, os_factor="4/3", fir_filter_taps=16 * 12 + 1,
               filter={"design": "least_squares", "taps_per_channel": 12,
                       "stopband_weight": 15.0})
    return cfg


@pytest.fixture
def small(tmp_path, monkeypatch):
    """BENCHMARK.json, run from a copy of the harness's data folders whose
    lowpsi.json is :func:`small_config`."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    here = tmp_path / "pstbench"
    copy_data(here)
    (here / "configs" / "lowpsi.json").write_text(json.dumps(small_config()))
    monkeypatch.setattr(run, "HERE", here)
    monkeypatch.setattr(run, "ROOT", tmp_path)
    return bench


def _run(bench, seconds=0.3, trace=False, patch=None):
    return run.run(bench, CELL, SEED, seconds, trace, device="cpu", traffic_params=SMALL,
                   patch=patch)


def _after_setup(traffic, fn):
    setup = traffic.setup

    def patched():
        setup()
        fn(traffic)
    traffic.setup = patched


def altered_answer(traffic):
    """One output sample of each request moved by 1e-3 of the peak."""
    def fn(t):
        execute = t.inv.execute

        def broken(state, x):
            state, out = execute(state, x)
            if out.numel():
                out[1, 3, out.shape[-1] // 2] += 1e-3 * out.abs().max()
            return state, out
        t.inv.execute = broken
    _after_setup(traffic, fn)


def coarse_channels_swapped(traffic):
    """The forward hands its output over with two coarse channels' slabs
    swapped."""
    def fn(t):
        execute = t.fb.execute

        def broken(state, x):
            state, out = execute(state, x)
            slab = 216
            out = out.clone()
            out[:, :slab], out[:, slab:2 * slab] = out[:, slab:2 * slab].clone(), out[:, :slab]
            return state, out
        t.fb.execute = broken
    _after_setup(traffic, fn)


def state_unchanged(stage):
    """A cascade stage that hands back the state it was given."""
    def patch(traffic):
        def fn(t):
            obj = t.fb if stage == "analysis" else t.inv
            execute = obj.execute

            def broken(state, x):
                return state, execute(state, x)[1]
            obj.execute = broken
        _after_setup(traffic, fn)
    return patch


def test_the_cell_is_in_the_benchmark():
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.by_name(bench["workloads"], CELL, "workload")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("lowpsi", "cascade_64mi", 1)
    e2e = {m["name"] for m in run.cell_metrics(bench, CELL, False)}
    assert e2e == {"throughput_msps", "latency_p95_ms", "setup_s"}
    assert [m["name"] for m in run.cell_metrics(bench, CELL, True)] == list(NEW)
    params = run.load_json(run.HERE / "traffic" / "cascade_64mi.json")
    assert params == {"kind": "cascade", "n_pol": 2, "block": 2**26, "buffer_samples": 2**27,
                      "blocks_per_sample": 2, "warm_requests": 8}
    limit = run.load_json(run.HERE / "limits" / f"{CELL}.json")["max_rel_err"]
    assert limit["lower"] < limit["limit"] and 10 * limit["limit"] <= limit["upper"]


def test_the_sps_design_is_the_programs_cached_design(tmp_path):
    """The program designs and caches sps's taps in a copy of config/; read
    back, they equal lowpsi.json's least-squares design bitwise."""
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    (tmp_path / "config").mkdir()
    shutil.copy(run.ROOT / "config" / "test.config.json", tmp_path / "config")
    cached = load_config("sps", str(tmp_path / "config" / "test.config.json"))
    h = cached.load_fir_filter_coeff()
    assert os.path.exists(cached.fir_filter_path)
    cfg = run.load_json(run.HERE / "configs" / "lowpsi.json")
    assert h.shape == (6145,) and np.array_equal(h, design.prototype_filter(cfg))


def test_the_firmware_taps_are_a_bitwise_copy():
    cfg = run.load_json(run.HERE / "configs" / "lowpsi.json")["stage2"]
    copy = run.ROOT / cfg["filter"]["path"]
    assert copy.parent == run.HERE / "configs"
    assert copy.read_bytes() == (run.ROOT / "config" / "PST_filtertaps.txt").read_bytes()
    h = design.prototype_filter(cfg)
    assert h.shape == (3072,)
    assert np.array_equal(h, np.loadtxt(run.ROOT / "config" / "PST_filtertaps.txt"))


def test_the_kind_and_its_reference_load_alone():
    """Loading the kind imports neither JAX nor the program (the kind
    imports the program inside its functions); the reference imports
    nothing of the program either."""
    code = (
        "import json, sys\n"
        "from pstbench.run import HERE, load_module\n"
        "load_module(HERE / 'references' / 'cascade.py')\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "kind = load_module(HERE / 'kinds' / 'cascade.py').KIND\n"
        "print(json.dumps({'ref': ref, 'kind': sorted({m.split('.')[0] for m in sys.modules}),"
        " 'name': kind.__name__}))\n")
    env = dict(os.environ, PYTHONPATH=str(run.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pstbench_references_cascade" in res["ref"] and res["name"] == "Cascade"
    for top in (res["ref"], res["kind"]):
        assert not set(top) & {"ska_pst_dsp_tpu_torch", *run.FORBIDDEN}


def test_the_kind_counts_its_work_by_the_rule():
    """Three steps' FFT-optimal flops a complex input sample, and 16 B (the
    chain gives back as many samples as it takes: 256 coarse channels x
    25,920 a block = 216 x 192 x 160 input samples)."""
    cfg = run.load_json(run.HERE / "configs" / "lowpsi.json")
    kind = generator.kind("cascade")(run.load_json(run.HERE / "traffic" / "cascade_64mi.json"),
                                     cfg, design.prototype_filter(cfg), 1, "cpu")
    fft = roofline.fft_flops
    per_sample = ((4 * 6400 + fft(256)) / 216 + 256 / 216 / 192 * (4 * 3072 + fft(256))
                  + 256 / (216 * 192 * 160) * (216 * fft(256) + 6 * 216 * 192 + fft(41472)))
    hbm, fp32 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    n = 2 * 2**26
    least = kind.least_seconds(n, "NVIDIA H100 80GB HBM3")
    assert least == pytest.approx(max(per_sample * n / fp32, 16 * n / hbm), rel=1e-12)
    assert kind.least_seconds(n, "no such card") is None


def test_a_sound_run_is_correct(small):
    res = _run(small)
    assert res["correct"], res["checks"]
    assert res["checks"]["max_rel_err"]["value"] < 1e-6
    assert set(res["metrics"]) == {"throughput_msps", "latency_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", [altered_answer, coarse_channels_swapped,
                                   state_unchanged("analysis"), state_unchanged("inversion")])
def test_a_broken_cascade_is_not_correct(small, fault):
    res = _run(small, patch=fault)
    assert not res["correct"], res["checks"]


def test_a_traced_run_reports_the_new_metrics(small):
    # a window long enough for a few requests in the traced stretch (a
    # block of the plain versions takes about 0.15 s on the CPU)
    res = _run(small, seconds=3.0, trace=True)
    assert res["correct"] and set(res["metrics"]) == set(NEW)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["cascade_self_ms"] > 0 and m["composed_epilogue_ms"] > 0
    # a request copies stage 1's 32 streams and stage 2's 32 x 216 channels
    # of each of its spectra, complex64: tens of megabytes at this size
    assert 1e7 < m["corner_turn_bytes_per_request"] < 1e8


def test_a_program_without_the_new_spans_reads_nothing(small, monkeypatch):
    """The parent program has no cascade spans, no composed_epilogue span
    and no corner_turn_bytes counter: each new reader returns None."""
    from ska_pst_dsp_tpu_torch.utils import profiling

    counters, span = profiling.counters, profiling.span

    def old_counters():
        c = counters()
        del c["corner_turn_bytes"]
        return c

    new = {"two_stage.filterbank", "two_stage.inverse_filterbank", "corner_turn",
           "composed_epilogue"}
    monkeypatch.setattr(profiling, "counters", old_counters)
    from ska_pst_dsp_tpu_torch.models import two_stage
    from ska_pst_dsp_tpu_torch.ops.kernels import synthesis_fused

    for mod in (two_stage, synthesis_fused):
        monkeypatch.setattr(mod, "span", lambda name: span("old." + name) if name in new
                            else span(name))
    monkeypatch.setattr(two_stage.TwoStageFilterBank, "execute",
                        two_stage.TwoStageFilterBank.execute.__wrapped__)
    monkeypatch.setattr(two_stage.TwoStageInverseFilterBank, "execute",
                        two_stage.TwoStageInverseFilterBank.execute.__wrapped__)
    res = _run(small, seconds=3.0, trace=True)
    assert res["correct"] and res["metrics"] == {}
    assert torch.autograd._profiler_enabled() is False
