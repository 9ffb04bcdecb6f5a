"""Run one cell of the benchmark once and print its result line.

    python -m pstbench --workload low.oneshot --seed 7 --seconds 10 --trace 0

The cell, its configuration and the metrics come from ``BENCHMARK.json``
at the root of the checkout; each is found by its name: the configuration
in the file its entry names, the traffic mix in
``pstbench/traffic/<traffic>.json``, each metric's reader in
``pstbench/metrics/<metric>.py`` and the cell's limits in
``pstbench/limits/<workload>.json``; a traffic kind that
:mod:`pstbench.generator` lacks in ``pstbench/kinds/<kind>.py``, with its
plain reference in ``pstbench/references/``.

A run: set-up (imports, the card, the filter design, the program's
modules, the inputs, a fixed warm-up), then a closed loop of requests for
``--seconds``, then the check of the kept outputs against the kind's plain
reference (:meth:`pstbench.generator.Traffic.reference`) once the
program's state is freed.
With ``--trace 1`` it also records spans and profiles a steady stretch of
the window, and reports the per-layer metrics in place of the end-to-end
ones. Without a CUDA card it exits with code 2 and prints no result;
where the JAX package, or JAX itself, is loaded in its process when the
result is due, it names what it found and exits with code 3, printing none.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from .trace import TraceData

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: outputs of this many samples (a sample: ``group`` consecutive requests)
#: are kept for the check, drawn from the seed over the whole window
KEEP = 4
#: the traced stretch starts this share into the window and lasts TRACE_S
TRACE_AT, TRACE_S = 0.25, 0.5
#: top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "ska_pst_dsp_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux's /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def by_name(items: List[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def load_module(path: Path):
    """A module of the benchmark loaded from its file, and held in
    ``sys.modules`` under its name (``pstbench_<folder>_<stem>``), which
    a dataclass in it needs."""
    spec = importlib.util.spec_from_file_location(f"pstbench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    (those that list it, or list no cells), or with ``trace`` its
    per-layer ones (those that list it, or list no cells and move one of
    its end-to-end metrics)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cfg: dict
    traffic: dict
    samples_per_request: int      # complex input samples, all polarisations
    bytes_per_request: int        # file bytes a request reads
    latencies: List[float]        # seconds, every request of the window
    window_s: float               # first hand-off to last completion
    setup_s: float
    device_name: str
    #: the kind's least time on this card over a number of complex input
    #: samples (Traffic.least_seconds); None on a card without a roofline
    least_seconds: Callable[[int], Optional[float]]
    trace: Optional[TraceData] = None
    #: the program's counters over the traced stretch (their growth from
    #: the profiler's start to its stop); None untraced or without counters
    counters: Optional[Dict[str, int]] = None


class Keeper:
    """Reservoir of KEEP samples, each ``group`` consecutive requests'
    records, drawn from the seed over however many requests the window
    holds."""

    def __init__(self, seed: int, group: int, slots: int = KEEP):
        self.rng = np.random.default_rng([seed % 2**64, 2])
        self.group, self.slots = group, slots
        self.kept: List[list] = []
        self.seen = 0
        self.current: Optional[int] = None

    def offer(self, k: int, record) -> None:
        """Record of the window's k-th request."""
        if k % self.group == 0:
            g = self.seen
            self.seen += 1
            if g < self.slots:
                self.kept.append([])
                self.current = g
            else:
                j = int(self.rng.integers(0, g + 1))
                self.current = j if j < self.slots else None
                if self.current is not None:
                    self.kept[self.current] = []
        if self.current is not None:
            self.kept[self.current].append(record)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|; inf where the shapes differ or a
    value is not finite."""
    if tuple(got.shape) != tuple(want.shape) or want.numel() == 0:
        return math.inf
    got = got.to(want.device, want.dtype)
    err = float((got - want).abs().max() / want.abs().max())
    return err if math.isfinite(err) else math.inf


def power_limit() -> Optional[float]:
    """The card's power limit in watts, from ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: Optional[float] = None,
        traffic_params: Optional[dict] = None, patch: Optional[Callable] = None) -> dict:
    """One run of ``workload``; returns the result dict (the result line's
    keys, ``checks`` last). ``t_start``: the process's start on
    ``time.perf_counter``'s clock, where set-up is counted from (default:
    this call). ``traffic_params`` and ``patch`` (called with the bound
    traffic before its set-up) serve the tests; ``device="cpu"`` runs the
    program's plain versions and skips the look for a card."""
    import torch

    from . import design, generator

    t_entry = time.perf_counter() if t_start is None else t_start
    cell = by_name(bench["workloads"], workload, "workload")
    cfg_entry = by_name(bench["configs"], cell["config"], "config")
    cfg = load_json(ROOT / cfg_entry["file"])
    params = traffic_params or load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    dev = torch.device(device)
    importlib.import_module("ska_pst_dsp_tpu_torch")

    filt = design.prototype_filter(cfg, ROOT)
    traffic = generator.make(params, cfg, filt, seed, dev)
    if patch is not None:
        patch(traffic)
    traffic.setup()
    try:
        return _measure(bench, workload, cfg, params, limits, traffic, seed, seconds, trace,
                        dev, t_entry)
    finally:
        traffic.close()


def growth(before: Optional[Dict[str, int]], after: Optional[Dict[str, int]]
           ) -> Optional[Dict[str, int]]:
    """Each counter's growth from ``before`` to ``after``; None where
    either reading is missing."""
    if before is None or after is None:
        return None
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _measure(bench, workload, cfg, params, limits, traffic, seed, seconds, trace, dev,
             t_entry) -> dict:
    """The warm-up, the window, the metrics and the check of :func:`run`."""
    import torch

    from . import program, stats
    from .trace import Profile, Tracer, breakdown, read_profile, tmp_dir

    tr = Tracer(trace)
    # the warm-up keeps outputs as the window does, so that the caching
    # allocator holds every block the window will ask for
    warm = Keeper(seed, traffic.group)
    for i in range(traffic.warm_requests):
        warm.offer(i, traffic.record(i, traffic.request(i, tr)))
    del warm
    i0 = traffic.warm_requests
    if trace:
        # the profiler's first start sets up its tracing for seconds, and
        # the counters' first reading imports what they read: done here, so
        # that the stretch in the window starts at once
        program.counters()
        first = Profile()
        first.start(i0)
        traffic.request(i0, Tracer(False))
        first.stop(i0)
        del first
        i0 += 1
    keeper = Keeper(seed, traffic.group)

    profile = Profile() if trace else None
    # the program's counters at the profiler's start, then their growth to its stop
    counted = None
    lat: List[float] = []
    gc.collect()
    gc.disable()
    i = i0
    t0 = time.perf_counter()
    trace_at, trace_end = t0 + TRACE_AT * seconds, math.inf
    while True:
        if profile is not None and profile.first is None and time.perf_counter() >= trace_at:
            counted = program.counters()
            profile.start(i)
        tr.request = i
        h = time.perf_counter()
        with tr.span("request"):
            out = traffic.request(i, tr)
        e = time.perf_counter()
        lat.append(e - h)
        keeper.offer(i - i0, traffic.record(i, out))
        del out
        if profile is not None and profile.first == i:
            # the stretch's first request pays for the profiler's start:
            # the stretch is timed from its end (and read without it)
            trace_end = e + TRACE_S
        i += 1
        if profile is not None and profile.last is None and e >= trace_end:
            profile.stop(i)
            counted = growth(counted, program.counters())
        if e - t0 >= seconds:
            break
    if profile is not None and profile.first is not None and profile.last is None:
        profile.stop(i)
        counted = growth(counted, program.counters())
    window = e - t0
    gc.enable()
    setup_s = t0 - t_entry

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    tmp = tmp_dir()
    tag = f"{workload}.{seed}.{os.getpid()}"
    td = None
    if trace:
        tr.dump(os.path.join(tmp, f"{tag}.spans.json"))
        if profile.first is not None:
            td = read_profile(profile, os.path.join(tmp, f"{tag}.trace.json"))
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    record = Run(cfg, params, traffic.samples_per_request, traffic.bytes_per_request, lat,
                 window, setup_s, device_name,
                 functools.partial(traffic.least_seconds, device_name=device_name), td,
                 counted)
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    kept = [r for sample in keeper.kept for r in sample]
    traffic.free_program()
    del keeper
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pairs = traffic.pairs(kept, traffic.reference(dev))
    err = max((rel_err(g, w) for g, w in pairs), default=math.inf)
    checks = {"max_rel_err": {"value": err, "limit": limits["max_rel_err"]["limit"]}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": device_name,
                "count": 1, "memory_peak_bytes": int(mem_peak)}
    if dev.type == "cuda":
        dev_info["power_limit_w"] = power_limit()
    result = {"correct": correct, "attempted": len(lat), "failed": 0, "metrics": metrics,
              "device": dev_info,
              "window": {"seconds": window, "setup_s": setup_s,
                         **{f"p{q}_ms": stats.percentile(lat, q) * 1e3 for q in (0, 50, 99, 100)}}}
    if td is not None:
        busy = sum(b - a for a, b in stats.union([(a, b) for _, a, b in td.device],
                                                  *td.window))
        dev_info["busy_s"] = busy / 1e6
        dev_info["window_s"] = (td.window[1] - td.window[0]) / 1e6
        result["breakdown"] = breakdown(td)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    t_start = time.perf_counter() - process_age()
    p = argparse.ArgumentParser(prog="python -m pstbench", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    chips = by_name(bench["workloads"], a.workload, "workload")["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"pstbench: {a.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(bench, a.workload, a.seed, a.seconds, bool(a.trace), t_start=t_start)
    # the last look before the result: whatever the window, the metrics'
    # readers or the check loaded counts
    found = forbidden_modules()
    if found:
        print(f"pstbench: modules loaded in the benchmark's process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
