"""Shared pieces of the benchmark's tests: small traffic mixes and small
configurations that the CPU runs in seconds, and a cell of a new kind that
comes in as new files."""

import copy
import shutil
from pathlib import Path

import numpy as np
import pytest

#: each cell's traffic cut to a size the CPU runs in a second
SMALL = {
    "low.oneshot": {"kind": "oneshot", "n_pol": 2, "samples": 2**17, "windows": 2,
                    "warm_requests": 2},
    "mid.oneshot": None,  # mid's fold at its width does not fit a CPU test
    "low.stream": {"kind": "stream", "n_pol": 2, "block": 65536, "buffer_samples": 2**19,
                   "blocks_per_sample": 4, "warm_requests": 6},
    "low.dada": {"kind": "dada", "n_pol": 2, "samples": 2**17, "windows": 2,
                 "warm_requests": 2, "header": {"NPOL": "2"}},
}

#: SKA-Mid's analysis (zero-padded, OS 8/7, the two-stage design at 28
#: taps a channel) at 256 channels and L = 64, small enough for the CPU
NARROW_MID = {
    "name": "midn", "analysis": "polyphase_analysis_padded", "channels": 256,
    "os_factor": "8/7", "fir_filter_taps": 28 * 224 + 1,
    "filter": {"design": "two_stage", "os_taps_per_channel": 28, "stopband_weight": 15.0},
    "input_fft_length": 64, "input_overlap": 16, "temporal_taper": "tukey", "deripple": True,
}


#: the file cell, kept out of BENCHMARK.json while its runs spread too
#: widely for a bound (PERF.md), driven here from its data files
DADA_CELL = {"name": "low.dada", "config": "low", "traffic": "dada_8mi", "chips": 1,
             "why": "2 pol x 2^23 windows of a page-cached NBIT 32 DADA file"}


@pytest.fixture
def bench():
    """BENCHMARK.json, with the file cell added where it is missing."""
    from pstbench import run

    b = run.load_json(run.ROOT / "BENCHMARK.json")
    if all(w["name"] != DADA_CELL["name"] for w in b["workloads"]):
        b["workloads"].append(DADA_CELL)
    return b


#: the folders the harness finds things in by name
DATA = ("configs", "traffic", "metrics", "limits", "kinds", "references")
#: a sample of what a configuration of a new shape brings, laid out as
#: under pstbench/: a config whose filter is read from a file, a traffic
#: mix, limits, a kind, its reference and a metric reader
NEWKIND = Path(__file__).resolve().parent / "newkind"
NEWKIND_CELL = "low_taps.analysis"


def copy_data(here: Path) -> None:
    """Copy the harness's data folders (those it has) to ``here``."""
    from pstbench import run

    for d in DATA:
        if (run.HERE / d).is_dir():
            shutil.copytree(run.HERE / d, here / d)


@pytest.fixture
def new_kind(bench, tmp_path, monkeypatch):
    """(BENCHMARK.json with the cell of NEWKIND, the copy of the harness's
    data folders it runs from): the copy has NEWKIND's files added, the
    checkout's root is ``tmp_path``, and the taps file the config reads is
    written there."""
    from pstbench import design, run

    here = tmp_path / "pstbench"
    copy_data(here)
    shutil.copytree(NEWKIND, here, dirs_exist_ok=True)
    (tmp_path / "config").mkdir()
    np.save(tmp_path / "config" / "low_taps.npy",
            design.prototype_filter(run.load_json(run.HERE / "configs" / "low.json")))
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": "low_taps", "source": "test",
                             "file": "pstbench/configs/low_taps.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": NEWKIND_CELL, "config": "low_taps",
                               "traffic": "analysis_tiny", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "least_ms_per_msample", "unit": "ms",
                                "better": "lower", "bound": 0.25, "source": "host_clock",
                                "workloads": [NEWKIND_CELL]})
    monkeypatch.setattr(run, "HERE", here)
    monkeypatch.setattr(run, "ROOT", tmp_path)
    return bench, here
