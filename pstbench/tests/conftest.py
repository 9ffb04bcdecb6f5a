"""Shared pieces of the benchmark's tests: small traffic mixes and small
configurations that the CPU runs in seconds."""

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
