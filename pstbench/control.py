"""The control: the reference in the program's place, one precision down.

    python -m pstbench.control --workload low.oneshot --seeds 11 12 13

For each seed: the cell's traffic at its own size, as many requests as a
run keeps (KEEP samples, each ``group`` requests), then the program's
outputs and the kind's bfloat16 reference's outputs for the same requests,
each held to its float64 reference by the cell's number (``max_rel_err``).
One JSON line a seed: ``{"seed", "program", "control"}``. The control has
to read above the cell's limit, the program below it; the benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from . import design, generator, run
from .trace import Tracer


def readings(workload: str, seed: int, *, device="cuda", bench: Optional[dict] = None,
             traffic_params: Optional[dict] = None) -> dict:
    """{"program": err, "control": err} of ``workload`` on ``seed``."""
    bench = bench or run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.by_name(bench["workloads"], workload, "workload")
    cfg = run.load_json(run.ROOT / run.by_name(bench["configs"], cell["config"], "config")["file"])
    params = traffic_params or run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    filt = design.prototype_filter(cfg, run.ROOT)
    traffic = generator.make(params, cfg, filt, seed, torch.device(device))
    traffic.setup()
    tr = Tracer(False)
    keeper = run.Keeper(seed, traffic.group)
    n = traffic.warm_requests + run.KEEP * traffic.group
    for i in range(n):
        out = traffic.request(i, tr)
        if i >= traffic.warm_requests:
            keeper.offer(i - traffic.warm_requests, traffic.record(i, out))
    kept = [r for sample in keeper.kept for r in sample]
    traffic.free_program()
    exact = traffic.pairs(kept, traffic.reference(device))
    low = traffic.pairs(kept, traffic.reference(device, "bf16"))
    traffic.close()
    return {"program": max(run.rel_err(g, w) for g, w in exact),
            "control": max(run.rel_err(lw, w) for (_, lw), (_, w) in zip(low, exact))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pstbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("pstbench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in a.seeds:
        print(json.dumps({"workload": a.workload, "seed": seed, **readings(a.workload, seed)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
