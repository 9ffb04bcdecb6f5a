"""test_sgcht — pass/fail sweep of sgcht configurations.

The port's counterpart of :mod:`ska_pst_dsp_tpu.cli.test_sgcht`, the
equivalent of the reference's test_sgcht.m:1-57 (each invocation must
return 0) and the all_sgcht.m cartesian batch: run the sgcht chain matrix
(channelize / invert / two-stage / critical / combine) for the given
configs/signals, on ``--device`` (default the card).

    python -m ska_pst_dsp_tpu_torch.cli.test_sgcht -c low --signals complex_sinusoid

A case is SKIP only where sgcht refuses a combination as undefined
(:class:`.sgcht.ImpulseUndefined`) or the tester does not model it
(:class:`..models.testers.NotModeled`), or where a cascade is beyond the
sweep's reach (below). Any other exception (a kernel refusing a geometry,
a CUDA error) is a FAIL that carries its message. The report goes to
``products/report.test_sgcht.<cfgs>.<device type>.json`` unless
``--report`` names another path; it never overwrites the JAX package's
committed ``report.test_sgcht.<cfgs>.json``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import torch

from . import sgcht
from ..models.testers import NotModeled
from ..utils.config import load_config

module_logger = logging.getLogger(__name__)

#: the reference's per-config sweep (test_sgcht.m): args appended to
#: ``--signal S --cfg C --test``
SWEEP = [
    None,                                      # no channelisation (:5-9)
    [],                                        # channelize only
    ["--invert"],                              # channelize + invert
    ["--two_stage"],                           # two-stage channelize
    ["--two_stage", "--invert"],               # two-stage + invert
    ["--two_stage", "--critical"],             # critical-sampled two-stage
    ["--two_stage", "--critical", "--invert"],
    ["--two_stage", "--critical", "--invert", "--combine", "16"],
]

#: the refusals that mean "undefined for this combination"
UNDEFINED = (sgcht.ImpulseUndefined, NotModeled)


def default_report(cfgs, device) -> str:
    return os.path.join(sgcht.PRODUCTS_DIR, f"report.test_sgcht.{'-'.join(cfgs)}."
                        f"{torch.device(device).type}.json")


def run(argv=None) -> int:
    p = argparse.ArgumentParser(prog="test_sgcht")
    p.add_argument("-c", "--cfgs", nargs="+", default=["low"])
    p.add_argument("--signals", nargs="+",
                   default=["complex_sinusoid", "temporal_impulse"])
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--blocksz", type=int, default=131072)
    p.add_argument("--subset", type=int, default=0,
                   help="run only the first N sweep entries (0 = all)")
    p.add_argument("--device", default="cuda",
                   help="torch device sgcht runs on (default: the card)")
    p.add_argument("--report", default=None,
                   help="report path (default products/report.test_sgcht.<cfgs>.<device>.json)")
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)

    sweep = SWEEP[: a.subset] if a.subset else SWEEP
    failures = []
    results = {}
    for cfg in a.cfgs:
        for signal in a.signals:
            for extra in sweep:
                two_stage = extra is not None and "--two_stage" in extra
                if two_stage:
                    nch = load_config(cfg).channels
                    if nch > 1024:
                        # the cascade's inverse takes a whole inversion
                        # block of stage-2 spectra per coarse channel
                        # before it emits anything: ~nch^2 * L raw samples
                        # (mid: 4096^2 * 512 = 8.6 Gsamples), out of reach
                        # of an in-stream sweep of a few blocks
                        label = " ".join(
                            ["--signal", signal, "--cfg", cfg, "--test"]
                            + extra
                        )
                        results[label] = {
                            "status": "SKIP",
                            "reason": (
                                f"{nch}x{nch} cascade needs ~nch^2*L = "
                                f"{nch * nch * 512 / 1e9:.1f} Gsamples per "
                                "inversion block, beyond the in-stream sweep"
                            ),
                        }
                        module_logger.warning("SKIP %s (cascade scale)", label)
                        continue
                # two-stage cases need ~n_chan^2 more data before the
                # cascade emits anything (the reference streams 64-Msample
                # blocks, sgcht.m:481-495); scale the block size so the
                # in-stream testers actually see output, and place the
                # impulse beyond the stage-2 filter warm-up
                mult = 1
                if two_stage:
                    mult = 48 if "--invert" in extra else 8
                blocksz = a.blocksz * mult
                offset = (
                    blocksz if two_stage and signal == "temporal_impulse"
                    else 20000
                )
                args = [
                    "--signal", signal, "--test",
                    "--blocks", str(a.blocks), "--blocksz", str(blocksz),
                    "--offset", str(offset),
                ]
                if extra is not None:  # None: test_sgcht.m:5-9, the raw stream
                    args += ["--cfg", cfg] + extra
                label = " ".join(args)
                try:
                    rc = sgcht.run(args + ["--device", a.device])
                except UNDEFINED as exc:
                    module_logger.warning("SKIP %s (%s)", label, exc)
                    results[label] = {"status": "SKIP", "reason": str(exc)}
                    continue
                except Exception as exc:  # a fault: reported, the sweep goes on
                    module_logger.exception("FAIL %s", label)
                    results[label] = {"status": "FAIL",
                                      "error": f"{type(exc).__name__}: {exc}"}
                    failures.append(label)
                    continue
                status = "PASS" if rc == 0 else "FAIL"
                module_logger.info("%s: sgcht %s", status, label)
                results[label] = {"status": status, "rc": rc}
                if rc != 0:
                    failures.append(label)

    report_path = a.report or default_report(a.cfgs, a.device)
    os.makedirs(os.path.dirname(report_path) or ".", exist_ok=True)
    with open(report_path, "w") as f:
        json.dump(results, f, indent=1)
    module_logger.info("wrote %s", report_path)

    if failures:
        module_logger.error("%d failures:\n%s", len(failures),
                            "\n".join(failures))
        return 1
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
