"""BENCHMARK.json against the contract's shape, and the harness finding
configurations, traffic, limits and metrics by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

import pstbench
from pstbench import design, generator, reference, roofline, run

from .conftest import NEWKIND, NEWKIND_CELL, SMALL, copy_data

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["pstbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("pstbench/") and c["reduced"] == []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert "bound" not in m and UNIT.match(m["unit"]) and NAME.match(m["name"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_name_has_its_file(bench):
    for c in bench["configs"]:
        assert run.load_json(run.ROOT / c["file"])["name"] == c["name"]
    for w in bench["workloads"]:
        assert (run.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert run.load_json(run.HERE / "limits" / f"{w['name']}.json")["max_rel_err"]["limit"] > 0
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (run.HERE / "metrics" / f"{m['name']}.py").is_file()
    for path in (run.HERE / "metrics").glob("*.py"):
        assert callable(run.load_module(path).read)


@pytest.mark.parametrize("workload", ["low.oneshot", "mid.oneshot", "low.stream"])
def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric(bench, workload):
    e2e = {m["name"] for m in run.cell_metrics(bench, workload, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.cell_metrics(bench, workload, True)


def test_a_new_cell_is_new_files_and_entries(bench, tmp_path, monkeypatch):
    """A traffic mix, a metric and a cell's limits added as files, found by
    the names of new entries, with no file of the harness edited."""
    here = tmp_path / "pstbench"
    copy_data(here)
    (here / "traffic" / "tiny.json").write_text(json.dumps(SMALL["low.oneshot"]))
    (here / "metrics" / "requests_traced.py").write_text(
        "def read(run):\n    return None if run.trace is None else run.trace.requests\n")
    shutil.copy(run.HERE / "limits" / "low.oneshot.json", here / "limits" / "low.tiny.json")
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "low.tiny", "config": "low", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_traced", "unit": "count", "better": "higher",
                               "source": "program_span", "layer": "device",
                               "moves": "throughput_msps"})
    monkeypatch.setattr(run, "HERE", here)
    monkeypatch.setattr(run, "ROOT", tmp_path)
    res = run.run(bench, "low.tiny", 3, 0.2, False, device="cpu")
    assert res["correct"] and set(res["metrics"]) == {"throughput_msps", "latency_p95_ms",
                                                      "setup_s"}
    assert [m["name"] for m in run.cell_metrics(bench, "low.tiny", True)] == ["requests_traced"]


def _files(top: Path) -> dict:
    """{path relative to ``top``: bytes} of every file under it, caches and
    the tests left out."""
    return {p.relative_to(top): p.read_bytes() for p in top.rglob("*")
            if p.is_file() and not {"__pycache__", "tests"} & set(p.relative_to(top).parts)}


def test_a_new_kind_is_new_files(new_kind, monkeypatch):
    """A kind, its plain reference, its work count, a config whose filter
    is read from a file, a traffic mix, limits and a metric reader, all
    added as files beside a copy of the harness's data: the run is
    correct, reads the kind's own work count, and no file of the harness
    is edited."""
    bench, here = new_kind
    harness = _files(Path(pstbench.__file__).resolve().parent)
    monkeypatch.setitem(roofline.PEAKS, "cpu", (1e11, 1e12))
    res = run.run(bench, NEWKIND_CELL, 2**31 + 3, 0.3, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["checks"]["max_rel_err"]["value"] < 1e-6

    cfg = run.load_json(here / "configs" / "low_taps.json")
    params = run.load_json(here / "traffic" / "analysis_tiny.json")
    kind = generator.kind("analysis")
    assert kind.__module__ == "pstbench_kinds_analysis" and issubclass(kind, generator.Traffic)
    own = kind(params, cfg, design.prototype_filter(cfg, run.ROOT), 1, "cpu")
    least = res["metrics"]["least_ms_per_msample"]["value"]
    # bound by its bytes: 8 in and 8 * 4/3 out a sample over 1e11 B/s
    assert least == own.least_seconds(10**6, "cpu") * 1e3 == pytest.approx(8e6 * 7 / 3 / 1e8)
    assert least != roofline.least_seconds(reference.geometry(cfg), 10**6, "cpu") * 1e3

    copied, added = _files(here), _files(NEWKIND)
    assert not set(added) & set(harness)
    assert {p: copied[p] for p in copied if p not in added} == {
        p: b for p, b in harness.items() if p.parts[0] in ("configs", "traffic", "metrics",
                                                           "limits", "kinds", "references")}
    assert _files(Path(pstbench.__file__).resolve().parent) == harness


def test_an_unknown_kind_names_the_file_it_looked_for(new_kind):
    _, here = new_kind
    with pytest.raises(ValueError, match=re.escape(str(here / "kinds" / "nonesuch.py"))):
        generator.kind("nonesuch")
    (here / "kinds" / "hollow.py").write_text("KIND = dict\n")
    with pytest.raises(ValueError, match="no KIND that is a Traffic subclass"):
        generator.kind("hollow")
