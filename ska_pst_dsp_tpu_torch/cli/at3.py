"""AT3 analysis campaigns.

The port's counterpart of :mod:`ska_pst_dsp_tpu.cli.at3`: the chains run on
``--device`` (default the card, through the CUDA kernels).

* ``at3_565`` — the quantization study of at3_565_round_pfb_io.m: the
  square-wave test signal through the SPS + LowPSI two-stage critical chain
  (sgcht cfg=sps cfg2=lowpsi critical), once unquantized and once per
  rounding variant (round input / round output, unscaled and at the
  recorded optimal rms per bit depth, duty-cycle corrected by 1/sqrt(2)
  because the 50% duty cycle halves the estimated on-pulse variance).
  Unlike the reference (which only writes DADA files for later dspsr
  analysis), each variant is also scored in place: quantization SNR of the
  rounded chain against the unquantized run. Products:
  products/report.at3_565.<device type>.json (``--report`` names another
  path; the JAX package's committed products/report.at3_565.json stays as
  it is) + the DADA files.

* ``at3_152`` — the filter-design + purity campaign of AT3_152.m: design
  the three prototype filters (plots via analysis.plots.plot_fir_filter)
  and run the current_performance sweeps per config. Without matplotlib the
  figures are skipped and nothing else.

    python -m ska_pst_dsp_tpu_torch.cli.at3 565 [--blocks 2 --blocksz 2097152]
    python -m ska_pst_dsp_tpu_torch.cli.at3 152 [-c low low_alt] [-n 10]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

from ..io import dada
from .sgcht import PRODUCTS_DIR
from . import sgcht

module_logger = logging.getLogger(__name__)

# recorded optimal input rms per bit depth (at3_565_round_pfb_io.m:1-15)
OPTIMAL_RMS = {8: 33.8, 12: 462.6, 16: 3538.5}
DUTY_CYCLE_CORRECTION = 1.0 / np.sqrt(2.0)


def _run_variant(tag, extra, out_dir, blocks, blocksz, device):
    args = [
        "--signal", "square_wave", "--cfg", "sps", "--cfg2", "lowpsi",
        "--critical", "--blocks", str(blocks), "--blocksz", str(blocksz),
        "--output_dir", out_dir,
    ] + extra
    rc = sgcht.run(args + ["--device", device])
    if rc != 0:
        raise RuntimeError(f"sgcht failed for {tag}: rc={rc}")
    name = sgcht.output_file_name(sgcht.create_parser().parse_args(args))
    return os.path.join(out_dir, name)


def _snr_db(ref, test):
    """Quantization SNR: signal power of the reference chain over the power
    of (test - ref), in dB."""
    n = min(ref.shape[-1], test.shape[-1])
    r = ref[..., :n]
    d = test[..., :n] - r
    p_sig = float(np.mean(np.abs(r) ** 2))
    p_err = float(np.mean(np.abs(d) ** 2))
    if p_err == 0.0:
        return float("inf")
    return 10.0 * np.log10(p_sig / p_err)


def run_565(argv=None) -> int:
    p = argparse.ArgumentParser(prog="at3_565")
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--blocksz", type=int, default=2 * 1024 * 1024)
    p.add_argument("--output_dir", default=PRODUCTS_DIR)
    p.add_argument("--subset", type=int, default=0,
                   help="run only the first N variants (0 = all)")
    p.add_argument("--report", default=None,
                   help="report path (default products/report.at3_565.<device type>.json)")
    p.add_argument("--device", default="cuda",
                   help="torch device sgcht runs on (default: the card)")
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)
    os.makedirs(a.output_dir, exist_ok=True)

    variants = [("baseline", [])]
    variants.append(("rndInput", ["--rndInput"]))
    variants.append(("rndOutput", ["--rndOutput"]))
    for nbit, rms in OPTIMAL_RMS.items():
        scaled = rms * DUTY_CYCLE_CORRECTION
        if nbit == 8:
            variants.append(
                (f"rmsInput_{nbit}bit", ["--rmsInput", str(scaled)])
            )
        variants.append(
            (f"rmsOutput_{nbit}bit", ["--rmsOutput", str(scaled)])
        )
    if a.subset:
        variants = variants[: a.subset]

    report = {
        "chain": "square_wave -> sps (256ch 32/27) -> lowpsi (LowCBF "
                 "firmware, 216 kept) critical",
        "optimal_rms": OPTIMAL_RMS,
        "duty_cycle_correction": DUTY_CYCLE_CORRECTION,
        "variants": {},
    }
    ref_data = None
    ref_rms = None
    for tag, extra in variants:
        path = _run_variant(tag, extra, a.output_dir, a.blocks, a.blocksz, a.device)
        data, _ = dada.load(path)
        entry = {"file": os.path.basename(path)}
        rms = float(np.sqrt(np.mean(np.abs(data) ** 2)))
        entry["rms"] = rms
        if tag == "baseline":
            ref_data, ref_rms = data, rms
        else:
            # undo any rms pre-scaling before differencing
            scale = rms / ref_rms if ref_rms else 1.0
            entry["snr_db"] = round(_snr_db(ref_data, data / scale), 2)
        report["variants"][tag] = entry
        module_logger.info("%s: %s", tag, {k: v for k, v in entry.items()
                                           if k != "file"})

    out = a.report or os.path.join(
        PRODUCTS_DIR, f"report.at3_565.{torch.device(a.device).type}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    module_logger.info("wrote %s", out)
    return 0


def run_152(argv=None) -> int:
    """Note: ``low_alt`` runs but its purity is poor by construction — the
    alt design's passband edge (fscale/n_taps_per_chan, scaled through the
    interpft: ~1.33 channel widths, design_PFB_FIR_filter_alt.m:50-52) sits
    beyond the alias-fold offsets of the kept band, so adjacent-band images
    pass unattenuated regardless of whether fircls1 or this framework's
    least-squares stand-in designs it. The reference repo records no alt
    purity products either."""
    p = argparse.ArgumentParser(prog="at3_152")
    p.add_argument("-c", "--cfgs", nargs="+", default=["low"])
    p.add_argument("-n", "--npoints", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device of the purity sweeps (default: the card)")
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)

    from ..analysis import plots
    from ..design import fir
    from ..utils.rational import Rational
    from . import current_performance

    # filter designs + response plots (AT3_152.m:1-14)
    designs = {
        "FIR_filter_response.3072": (
            256, 4 / 3, fir.design_pfb_fir_filter(256, Rational(4, 3), 12)
        ),
        "alt_FIR_filter_response.3072": (
            256, 4 / 3, fir.design_pfb_fir_filter_alt(256, Rational(4, 3), 12)
        ),
        "two_stage_filter_response.100352": (
            4096, 8 / 7,
            fir.design_pfb_fir_filter_two_stage(4096, Rational(8, 7), 28),
        ),
    }
    os.makedirs(PRODUCTS_DIR, exist_ok=True)
    for name, (n_chan, osf, h) in designs.items():
        try:
            plots.plot_fir_filter(
                n_chan, osf, h, os.path.join(PRODUCTS_DIR, f"{name}.png")
            )
        except ImportError as exc:  # matplotlib optional
            module_logger.warning("plot %s skipped: %s", name, exc)

    for cfg in a.cfgs:
        for domain in ("temporal", "spectral"):
            rc = current_performance.run(
                ["-c", cfg, "-d", domain, "-n", str(a.npoints), "--device", a.device]
            )
            if rc not in (0, None):
                return rc
    return 0


def main():
    argv = sys.argv[1:]
    if not argv or argv[0] not in ("565", "152"):
        print("usage: at3 {565|152} [options]", file=sys.stderr)
        sys.exit(2)
    sys.exit(run_565(argv[1:]) if argv[0] == "565" else run_152(argv[1:]))


if __name__ == "__main__":
    main()
