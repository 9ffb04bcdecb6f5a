"""Scaling benchmark of the sharded pipelines.

Counterpart of :mod:`ska_pst_dsp_tpu.cli.scaling_bench`: the time-sharded
(1-D) and chan x time (2-D, dc = 2) SKA-Low round trips over growing
world sizes, each world one :func:`..parallel.distributed.spawn`:

    python -m ska_pst_dsp_tpu_torch.cli.scaling_bench --world 1 2 4
    python -m ska_pst_dsp_tpu_torch.cli.scaling_bench --world 1 2 --device cpu

Per world size it records the exchanges the run actually issued (calls and
payload bytes per kind, summed over the ranks, from the mesh's counters),
the backend and whether payloads were staged through host memory, each
rank's compute and exchange ms, and Msamples/s only where every rank has a
card of its own: ranks sharing one card (or the CPU) oversubscribe it and
cannot scale, as the JAX report's virtual mesh could not. ``comm_model``
gives the bytes each step must move per the pipelines' structure, over a
link bandwidth passed in (``--link-gbs``; default 450 GB/s, one direction
of an H100 SXM's NVLink 4, NVIDIA's data sheet).

Writes ``report.scaling.<device type>.json`` into ``--products`` (default
products/); the JAX package's ``report.scaling.json`` is not touched.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import sys
import tempfile

import numpy as np
import torch

from ..data_gen.config import products_dir
from ..design import fir
from ..parallel import corner_turn, sharded
from ..parallel.distributed import Call, Sharded, run_calls, spawn
from ..utils import geometry
from ..utils.rational import Rational

module_logger = logging.getLogger(__name__)

#: the benchmark's geometry: SKA-Low
N_CHAN, TAPS_PER_CHAN, L, OVERLAP = 256, 12, 256, 48
OS_FACTOR = Rational(4, 3)


def comm_model(n_chan, taps, L, ov, os_f, n_pol=2, dc=2, *, link_gbs: float) -> dict:
    """Bytes the sharded pipelines must move per rank per shard step,
    complex64 (8 bytes a sample), from their structure alone: the 1-D
    analysis halo (``padded_taps`` raw samples) and inversion halo
    (2 * overlap fine samples of every channel), and the 2-D corner turn's
    all-to-all ((dc - 1) / dc of the rank's phase-1 output). At a shard of
    64 Msamples (sgcht.m:481's block), per million output samples, and in
    seconds per Gsample over ``link_gbs`` GB/s."""
    step = geometry.analysis_step(n_chan, os_f)
    fl = geometry.padded_filter_length(taps, n_chan)
    geom = geometry.SynthesisGeometry(n_chan, L, ov, os_f)
    shard_raw = 64 * 1024 * 1024
    out_per_shard = (shard_raw // step) // geom.input_keep * geom.output_keep
    halo_analysis = n_pol * 8 * fl
    halo_synth = n_pol * 8 * 2 * ov * n_chan
    blocks = (shard_raw // step) // geom.input_keep
    a2a = n_pol * 8 * (n_chan // dc) * blocks * geom.fn_width * (dc - 1)

    def per_msample(b):
        return round(b / (out_per_shard / 1e6), 1)

    return {
        "shard_raw_samples": shard_raw,
        "out_samples_per_shard_step": out_per_shard,
        "halo_analysis_bytes": halo_analysis,
        "halo_synthesis_bytes": halo_synth,
        "all_to_all_bytes_2d": a2a,
        "bytes_per_Msample_1d": per_msample(halo_analysis + halo_synth),
        "bytes_per_Msample_2d": per_msample(halo_analysis + halo_synth + a2a),
        "modeled_comm_seconds_per_Gsample_2d": round(
            (halo_analysis + halo_synth + a2a) / (out_per_shard / 1e9) / (link_gbs * 1e9), 4),
        "link_gbs": link_gbs,
    }


def summarize(per_rank: list, n_samples: int, own_cards: bool) -> dict:
    """One case over every rank: exchanges summed over ranks, each rank's
    compute and exchange ms of its last run, and Msamples/s from the
    slowest rank's median run (first run dropped) where ``own_cards``."""
    collectives = {}
    for r in per_rank:
        for kind, s in r["exchanges"].items():
            if s["calls"]:
                e = collectives.setdefault(kind, {"calls": 0, "bytes": 0, "staged_bytes": 0})
                for k in e:
                    e[k] += s[k]
    out = {"collectives": collectives or {"none": {"calls": 0, "bytes": 0, "staged_bytes": 0}},
           "compute_ms": [r["compute_ms"] for r in per_rank],
           "exchange_ms": [r["exchange_ms"] for r in per_rank],
           "raw_msamples": n_samples / 1e6}
    if own_cards:
        ms = max(statistics.median(r["ms"][1:] or r["ms"]) for r in per_rank)
        out["msps"] = n_samples / (ms * 1e3)
    return out


def run(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scaling_bench")
    p.add_argument("--world", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--samples-per-rank", type=int, default=192 * 4 * 1200)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--link-gbs", type=float, default=450.0,
                   help="link bandwidth of comm_model, GB/s one way")
    p.add_argument("--products", default=products_dir, help="directory of the report")
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)

    device = torch.device(a.device)
    filt = fir.design_pfb_fir_filter(N_CHAN, OS_FACTOR, TAPS_PER_CHAN)
    low = (filt, N_CHAN, OS_FACTOR, L, OVERLAP)
    cuda = device.type == "cuda"
    report = {
        "platform": device.type,
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "geometry": "low (256 chan, OS 4/3, 3073 taps, L=256, ov=48)",
        "note": ("Per world size: the exchanges the run issued (calls, payload bytes and "
                 "bytes staged through host memory, summed over ranks), each rank's compute "
                 "and exchange ms, and Msamples/s only where every rank has a card of its "
                 "own (NCCL); ranks sharing a card or the CPU oversubscribe it."),
        "runs": {},
        "comm_model": {
            "low": comm_model(256, 3073, 256, 48, Rational(4, 3), link_gbs=a.link_gbs),
            "mid": comm_model(4096, 100353, 512, 128, Rational(8, 7), link_gbs=a.link_gbs),
        },
    }
    for world in a.world:
        n_dat = world * a.samples_per_rank
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((2, n_dat), dtype=np.float32)
             + 1j * rng.standard_normal((2, n_dat), dtype=np.float32)).astype(np.complex64)
        with tempfile.TemporaryDirectory(prefix="ska_pst_scaling_") as tmp:
            path = os.path.join(tmp, "x.npy")
            np.save(path, x)
            calls = [Call(sharded.sharded_round_trip, (Sharded(path), *low), runs=a.reps + 1)]
            if world % 2 == 0:
                calls.append(Call(corner_turn.sharded_round_trip_2d, (Sharded(path), *low),
                                  mesh_2d=(2, world // 2), runs=a.reps + 1))
            ranks = spawn(run_calls, world, device=a.device, timeout=600.0, args=(calls,))
        backend = ranks[0][0]["backend"]
        own_cards = cuda and backend == "nccl"
        entry = {"backend": backend, "staged": ranks[0][0]["staged"],
                 "1d": summarize([r[0] for r in ranks], x.size, own_cards)}
        if world % 2 == 0:
            entry["2d_2xT"] = summarize([r[1] for r in ranks], x.size, own_cards)
        report["runs"][str(world)] = entry
        module_logger.info("world=%d: %s", world, entry)

    os.makedirs(a.products, exist_ok=True)
    path = os.path.join(a.products, f"report.scaling.{device.type}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    module_logger.info("wrote %s", path)
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
