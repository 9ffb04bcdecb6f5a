"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU (the program's plain
versions; the look for a card skipped) at a small size, with one fault
planted where the program produces its answer, and sees ``correct`` come
out false; the same run unbroken comes out true."""

import pytest
import torch

from pstbench import generator, run

from .conftest import NEWKIND_CELL, SMALL

SEED = 2**31 + 99


def _run(bench, workload, patch=None):
    return run.run(bench, workload, SEED, 0.3, False, device="cpu",
                   traffic_params=SMALL[workload], patch=patch)


def _after_setup(traffic, fn):
    setup = traffic.setup

    def patched():
        setup()
        fn(traffic)

    traffic.setup = patched


def half_batch(traffic):
    """The round trip computes the first polarisation and leaves the
    other out."""
    def fn(t):
        model = t.model
        t.model = lambda x: torch.cat([model(x[:1]), torch.zeros_like(model(x[:1]))])
    _after_setup(traffic, fn)


def altered_answer(traffic):
    """One output sample of each request moved by 1e-3 of the peak."""
    def fn(t):
        model = t.model

        def broken(x):
            out = model(x)
            out[0, 0, out.shape[-1] // 2] += 1e-3 * out.abs().max()
            return out
        t.model = broken
    _after_setup(traffic, fn)


def state_unchanged(stage):
    """A streaming stage that hands back the state it was given."""
    def patch(traffic):
        def fn(t):
            obj = t.fb if stage == "analysis" else t.inv
            execute = obj.execute

            def broken(state, x):
                return state, execute(state, x)[1]
            obj.execute = broken
        _after_setup(traffic, fn)
    return patch


def altered_ingest(monkeypatch):
    """The ingest hands over one sample of each window changed."""
    load = generator.system.load_split

    def broken(path, count, offset, device):
        x = load(path, count, offset, device)
        x[1, 0, count // 2] += 1.0
        return x
    monkeypatch.setattr(generator.system, "load_split", broken)


@pytest.mark.parametrize("workload", ["low.oneshot", "low.stream", "low.dada"])
def test_sound_run_is_correct(bench, workload):
    res = _run(bench, workload)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", ["low.oneshot", "low.dada"])
@pytest.mark.parametrize("fault", [half_batch, altered_answer])
def test_broken_round_trip_is_not_correct(bench, workload, fault):
    res = _run(bench, workload, fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [None, half_batch, altered_answer])
def test_a_new_kind_is_held_to_its_own_reference(new_kind, fault):
    """The kind that came in as files (conftest.NEWKIND), checked against
    the reference it brought: sound, it is correct; with a polarisation
    left out or one answer altered, it is not."""
    bench, _ = new_kind
    res = run.run(bench, NEWKIND_CELL, SEED, 0.3, False, device="cpu", patch=fault)
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("stage", ["analysis", "inversion"])
def test_stream_state_left_unchanged_is_not_correct(bench, stage):
    res = _run(bench, "low.stream", state_unchanged(stage))
    assert not res["correct"], res["checks"]


def test_broken_ingest_is_not_correct(bench, monkeypatch):
    altered_ingest(monkeypatch)
    res = _run(bench, "low.dada")
    assert not res["correct"], res["checks"]
