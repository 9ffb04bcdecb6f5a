"""The readers of the program's own spans and counters (pstbench.program
and the four metrics built on it), on synthetic spans and in traced runs
on the CPU."""

import json

import pytest
import torch

from pstbench import program, run, trace
from pstbench.trace import TraceData

from .conftest import SMALL

SEED = 2**31 + 17
NEW = ("wrapper_host_ms", "dispatch_host_ms", "chain_self_ms", "carry_bytes_per_request")
H, P = trace.PREFIX, "pst:"

#: two requests (the first of the stretch is left out, as read_profile
#: does) of a one-shot chain, microseconds on the profiler's clock
EVENTS = [
    (H + "request", 0.0, 90.0), (H + "issue", 1.0, 80.0), (P + "forward", 2.0, 79.0),
    (H + "request", 100.0, 200.0), (H + "issue", 101.0, 181.0),
    (P + "forward", 102.0, 180.0),
    (P + "kernel.analysis_fused", 104.0, 120.0),
    (P + "inversion", 122.0, 176.0),
    (P + "kernel.synthesis_fused", 123.0, 140.0),
    (P + "dispatch", 141.0, 150.0),
    (P + "kernel.ifft_fused", 151.0, 170.0),
    (H + "request", 200.0, 300.0), (H + "issue", 201.0, 291.0),
    (P + "forward", 202.0, 290.0),
    (P + "kernel.analysis_fused", 204.0, 220.0),
    (P + "inversion", 222.0, 286.0),
    (P + "kernel.synthesis_fused", 223.0, 240.0),
    (P + "dispatch", 241.0, 260.0),
    (P + "kernel.ifft_fused", 261.0, 280.0),
    ("aten::empty", 105.0, 106.0),
]
#: a stream block: both stages, each with its carry
STREAM = [
    (H + "request", 0.0, 10.0),
    (H + "request", 100.0, 200.0), (H + "issue", 101.0, 195.0),
    (P + "filterbank", 102.0, 140.0), (P + "carry", 103.0, 110.0),
    (P + "kernel.analysis_fused", 112.0, 136.0),
    (P + "inverse_filterbank", 141.0, 194.0), (P + "carry", 142.0, 150.0),
    (P + "inversion", 152.0, 190.0), (P + "dispatch", 160.0, 162.0),
]


class Fake:
    """What a reader reads of a run, with the program's events planted."""

    def __init__(self, events, td=None, latencies=10, warm=4):
        self.events = events
        self.trace = td or TraceData((100.0, 300.0), [], [], 2)
        self.latencies = [0.001] * latencies
        self.traffic = {"warm_requests": warm}


@pytest.fixture
def planted(monkeypatch):
    """Readers of a Fake read its events as the profiled stretch's."""
    monkeypatch.setattr(program, "_stretch", lambda: object())
    holder = {}
    monkeypatch.setattr(program, "_events", lambda prof: holder["events"])
    monkeypatch.setattr(program, "_read", {})

    def read(name, fake):
        holder["events"] = fake.events
        program._read.clear()
        return run.load_module(run.HERE / "metrics" / f"{name}.py").read(fake)
    return read


def test_spans_grouped_by_the_request_that_holds_them():
    reqs = program.spans_by_request(EVENTS, P)
    assert [r["request"] for r in reqs] == [[(100.0, 200.0)], [(200.0, 300.0)]]
    assert reqs[0]["dispatch"] == [(141.0, 150.0)]
    assert all("aten::empty" not in r and "issue" not in r for r in reqs)


@pytest.mark.parametrize("name,events,want", [
    # the union of kernel.*, inversion and dispatch: 16 + 54 (holding the
    # rest), then 16 + 64: median 75 us
    ("wrapper_host_ms", EVENTS, 0.075),
    ("dispatch_host_ms", EVENTS, 0.014),
    # forward 78 less 70, 88 less 80
    ("chain_self_ms", EVENTS, 0.008),
    ("wrapper_host_ms", STREAM, 0.062),
    # both stages (38 + 53) less analysis 24 and inversion 38; carries stay
    ("chain_self_ms", STREAM, 0.029),
    ("dispatch_host_ms", STREAM, 0.002),
])
def test_span_readers_on_synthetic_spans(planted, name, events, want):
    assert planted(name, Fake(events)) == pytest.approx(want)


def test_carry_reader_over_every_request_handed_over(planted, monkeypatch):
    monkeypatch.setattr(program, "counters", lambda: {"carry_bytes": 3 * 15 * 1000})
    # warm-up 4, the profiler's first request, the window's 10
    assert planted("carry_bytes_per_request", Fake(STREAM)) == 3000


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_or_counters_reads_nothing(planted, monkeypatch, name):
    monkeypatch.setattr(program, "prefix", lambda: None)
    monkeypatch.setattr(program, "counters", lambda: None)
    assert planted(name, Fake(EVENTS)) is None


@pytest.mark.parametrize("name", NEW[:3])
def test_no_stretch_or_no_span_reads_nothing(planted, monkeypatch, name):
    only_requests = [e for e in EVENTS if not e[0].startswith(P)]
    assert planted(name, Fake(only_requests)) is None
    monkeypatch.setattr(program, "_stretch", lambda: None)
    assert planted(name, Fake(EVENTS)) is None


def test_read_trace_keeps_program_spans_out_of_the_harness_spans(tmp_path):
    """The program's annotations change neither the harness's spans nor the
    device operations the existing metrics count."""
    def chrome(events):
        return {"traceEvents": [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a,
                                 "dur": b - a} for n, a, b in events]
                + [{"ph": "X", "cat": "kernel", "name": "void k<1>(float*)", "ts": 110.0,
                    "dur": 5.0}]}
    both, harness = tmp_path / "both.json", tmp_path / "harness.json"
    both.write_text(json.dumps(chrome(EVENTS)))
    harness.write_text(json.dumps(chrome([e for e in EVENTS if not e[0].startswith(P)])))
    got, want = trace.read_trace(str(both)), trace.read_trace(str(harness))
    assert got == want and {n for n, *_ in got["spans"]} == {"request", "issue"}
    assert got["device"] == [("k", 110.0, 115.0)]


def test_idle_gaps_name_the_program_span(planted):
    # the trace's clock is the profiler's moved by 1000 us; the device runs
    # 1100-1150 and 1200-1292: the gap 1150-1200 (midpoint 1175, inside
    # the inversion and past its kernels) and 1292-1300 (past the forward)
    td = TraceData((1100.0, 1300.0), [("k", 1100.0, 1150.0), ("k", 1200.0, 1292.0)],
                   [("request", 1100.0, 1200.0), ("issue", 1101.0, 1181.0),
                    ("request", 1200.0, 1300.0), ("issue", 1201.0, 1291.0)], 2)
    fake = Fake(EVENTS, td)
    planted("chain_self_ms", fake)
    gaps = program.idle_gaps(fake)
    assert [g[0] for g in gaps] == ["issue/inversion", "request"]
    assert [g[1] for g in gaps] == pytest.approx([50e-6, 8e-6])
    del td.spans[1]
    assert program.idle_gaps(fake)[0][0] == "request/inversion"


@pytest.mark.parametrize("workload", ["low.oneshot", "low.stream"])
def test_traced_run_reports_the_program_metrics(bench, workload):
    # a window long enough for a few requests in the traced stretch on a
    # slow CPU (a stream block of the plain versions takes up to 0.2 s)
    res = run.run(bench, workload, SEED, 2.0, True, device="cpu",
                  traffic_params=SMALL[workload])
    want = set(NEW) if workload == "low.stream" else set(NEW[:3])
    assert want <= set(res["metrics"]) and res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # each request's program spans lie inside its issue span, so each
    # median is below issue_ms's; the program does nearly all the issuing.
    # SKA-Low's inversion is one kernel: no epilogue route is chosen
    assert m["dispatch_host_ms"] == 0 and 0 < m["wrapper_host_ms"] <= m["issue_ms"]
    assert 0 < m["chain_self_ms"] <= m["issue_ms"]
    assert m["wrapper_host_ms"] + m["chain_self_ms"] > 0.5 * m["issue_ms"]
    if workload == "low.stream":
        assert m["carry_bytes_per_request"] > 2 * 8 * 65536


@pytest.mark.parametrize("traced", [True, False])
def test_counters_cover_the_traced_stretch(bench, monkeypatch, traced):
    """Run.counters is the program's counters' growth from the profiler's
    start to its stop: for the stream's carry, the bytes its carries wrote
    in the requests the profiler recorded; None in an untraced run."""
    records, grown = [], []
    make_run = run.Run
    monkeypatch.setattr(run, "Run", lambda *a, **k: records.append(make_run(*a, **k))
                        or records[-1])

    def patch(traffic):
        request = traffic.request

        def counted(i, tr):
            before = program.counters()["carry_bytes"]
            out = request(i, tr)
            if tr.enabled and torch.autograd._profiler_enabled():
                grown.append(program.counters()["carry_bytes"] - before)
            return out
        traffic.request = counted

    res = run.run(bench, "low.stream", SEED, 2.0 if traced else 0.3, traced, device="cpu",
                  traffic_params=SMALL["low.stream"], patch=patch)
    assert res["correct"]
    (record,) = records
    if not traced:
        assert record.counters is None
        return
    assert set(record.counters) == set(program.counters())
    assert len(grown) >= 2 and record.counters["carry_bytes"] == sum(grown) > 0
