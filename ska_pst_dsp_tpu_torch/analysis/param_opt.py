"""PFB inversion parameter studies.

Counterpart of :mod:`ska_pst_dsp_tpu.analysis.param_opt`, the reference's
matlab/pfb_param_opt/ scripts: derippling_effect.m (reconstruction error
with deripple on and off versus filter length), overlap_effect.m and
overlap_parameter_search.m (overlap-save discard versus purity),
phase_offset_effect.m (tone phase versus reconstruction error) and
pipeline.m (one tone and one impulse at the study geometry). Each study
runs tones or impulses through a one-shot analysis and inversion with a
swept parameter and returns its records.

The studies run the port's **composed** ``ops.polyphase_analysis`` and
``ops.polyphase_synthesis`` on the given device (the card unless the caller
asks for the CPU), as the JAX module runs its composed XLA ops and not its
Pallas kernels. Their 64- and 8-channel geometries are below the 128-point
minimum of the register passes every kernel's DFT runs on
(``ops/kernels/__init__.py`` ``reg_plan``); a kernel for them would be a
feature the JAX package lacks. No kernel is tried for them, and nothing
gives way.

    python -m ska_pst_dsp_tpu_torch.analysis.param_opt --study overlap
    python -m ska_pst_dsp_tpu_torch.analysis.param_opt --study pipeline --device cpu

Reports go to ``products/param_opt.<study>.<device type>.json`` (the search
to ``products/report.param_search.<device type>.json``), never a committed
product's name.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

from ..data_gen.config import products_dir
from ..data_gen.generate_test_vector import complex_sinusoid, time_domain_impulse
from ..data_gen.util import NumpyEncoder
from ..design import fir
from ..ops import polyphase_analysis, polyphase_synthesis
from ..utils import geometry
from ..utils.rational import Rational
from ..verify.util import DomainPerformance, dB, mean_spurious

module_logger = logging.getLogger(__name__)


def round_trip(sig, filt, n_chan, os_f, L, ov, deripple, taper="tukey", device="cuda"):
    """(input aligned with the output, inverted stream) of one tone or
    impulse through the composed analysis and inversion on ``device``."""
    x = torch.as_tensor(np.asarray(sig)[None, None], device=device)
    chan = polyphase_analysis(x, filt, n_chan, os_f)
    inv = polyphase_synthesis(chan, L, os_f, input_overlap=ov,
                              deripple_coeff=filt if deripple else None,
                              temporal_taper=taper)[0, 0].cpu().numpy()
    shift = geometry.total_sample_shift(n_chan, os_f, filt.size, ov)
    n = min(inv.size, sig.size - shift)
    return sig[shift: shift + n], inv[:n]


def derippling_effect(n_chan=64, os_f=Rational(4, 3), L=128, ov=24,
                      taps_per_chan=(6, 8, 12, 16, 20), freq_bin=0.23, device="cuda"):
    """Deripple on/off reconstruction error versus filter length
    (derippling_effect.m)."""
    perf = DomainPerformance(guard=1)
    records = []
    for tpc in taps_per_chan:
        filt = fir.design_pfb_fir_filter(n_chan, os_f, tpc)
        block = os_f.normalize(L) * n_chan
        sig = complex_sinusoid(block * 4, [freq_bin], [np.pi / 4], dtype=np.complex64)
        for deripple in (False, True):
            inp, inv = round_trip(sig, filt, n_chan, os_f, L, ov, deripple, device=device)
            d = perf.temporal_difference(inp, inv)
            records.append({"taps_per_chan": tpc, "deripple": deripple,
                            "mean_diff": d["mean"], "max_diff": d["max"]})
            module_logger.info("%s", records[-1])
    return records


def overlap_effect(n_chan=64, os_f=Rational(4, 3), L=128,
                   overlaps=(0, 8, 16, 24, 32, 40), freq_bin=0.23, device="cuda"):
    """Overlap-discard size versus spectral purity (overlap_effect.m /
    overlap_parameter_search.m); a geometry the inversion refuses is
    skipped, as in the JAX study."""
    perf = DomainPerformance(guard=1)
    filt = fir.design_pfb_fir_filter(n_chan, os_f, 12)
    block = os_f.normalize(L) * n_chan
    records = []
    for ov in overlaps:
        sig = complex_sinusoid(block * 4, [freq_bin], [np.pi / 4], dtype=np.complex64)
        try:
            inp, inv = round_trip(sig, filt, n_chan, os_f, L, ov, True, device=device)
        except ValueError:
            continue
        nfft = (inv.size // block) * block
        if nfft == 0:
            continue
        r = perf.spectral_performance(inv, nfft)
        d = perf.temporal_difference(inp, inv)
        records.append({"overlap": ov, **r, "mean_diff": d["mean"]})
        module_logger.info("%s", records[-1])
    return records


def phase_offset_effect(n_chan=64, os_f=Rational(4, 3), L=128, ov=24,
                        phases=np.linspace(0, 2 * np.pi, 9), device="cuda"):
    """Tone phase versus reconstruction error (phase_offset_effect.m)."""
    perf = DomainPerformance(guard=1)
    filt = fir.design_pfb_fir_filter(n_chan, os_f, 12)
    block = os_f.normalize(L) * n_chan
    records = []
    for ph in phases:
        sig = complex_sinusoid(block * 4, [0.23], [float(ph)], dtype=np.complex64)
        inp, inv = round_trip(sig, filt, n_chan, os_f, L, ov, True, device=device)
        d = perf.temporal_difference(inp, inv)
        records.append({"phase": float(ph), "mean_diff": d["mean"], "max_diff": d["max"]})
        module_logger.info("%s", records[-1])
    return records


def overlap_parameter_search(n_chan=256, os_f=Rational(4, 3), fft_lengths=(512, 1024, 2048),
                             overlaps=(128, 256, 512), npoints=200, nblocks=3,
                             window="tukey", device="cuda"):
    """fft_length x overlap purity search (overlap_parameter_search.m:1-216):
    for every (input_fft_length, overlap) with L/ov > 2 (:68-70), about
    ``npoints`` tone frequencies across one block (:30-35) through the
    round trip, with the reference's six measures (:59-66) at its 2*block
    FFT length (:106)."""
    perf = DomainPerformance(guard=1)
    filt = fir.design_pfb_fir_filter(n_chan, os_f, 12)
    records = []
    for L in fft_lengths:
        for ov in overlaps:
            if L / ov <= 2:
                continue
            block = os_f.normalize(L) * n_chan
            nbins = nblocks * block
            nfft = min(2 * block, nbins)
            stepf = max(1, round(block / npoints))
            for fbin in np.arange(1, block + 1, stepf) * nblocks:
                sig = complex_sinusoid(nbins, [int(fbin)], [np.pi / 4], dtype=np.complex64)
                try:
                    inp, inv = round_trip(sig, filt, n_chan, os_f, L, ov, True, taper=window,
                                          device=device)
                except ValueError:
                    continue
                if inv.size < nfft:
                    continue
                d = perf.temporal_difference(inp, inv)
                s = perf.spectral_performance(inv, nfft)
                spec = np.fft.fft(np.asarray(inv).ravel()[:nfft]) / nfft
                records.append({
                    "fft_length": L, "overlap": ov, "window": window,
                    "frequency": int(fbin),
                    "diff_max": float(dB(d["max"])), "diff_sum": float(dB(d["sum"])),
                    "diff_mean": float(dB(d["mean"])),
                    "max_spurious": s["max_spurious"], "total_spurious": s["total_spurious"],
                    "mean_spurious": mean_spurious(spec),
                })
            last = [r for r in records if r["fft_length"] == L and r["overlap"] == ov]
            if last:
                module_logger.info("L=%d ov=%d: %d points, worst max_spurious %.1f dB", L, ov,
                                   len(last), max(r["max_spurious"] for r in last))
    return records


def pipeline_study(n_chan=8, os_f=Rational(8, 7), L=128, nblocks=400, device="cuda"):
    """The pfb_param_opt study script (pipeline.m:1-80): one tone and one
    impulse through the round trip at the study geometry (8 channels, OS
    8/7, L=128, zero overlap), each record with the run's meta."""
    perf = DomainPerformance(guard=1)
    filt = fir.design_pfb_fir_filter(n_chan, os_f, 10)
    block = os_f.normalize(L) * n_chan
    nbins = nblocks * block
    records = []

    tone = complex_sinusoid(nbins, [4], [np.pi / 4], dtype=np.complex64)
    inp, inv = round_trip(tone, filt, n_chan, os_f, L, 0, True, device=device)
    nfft = (inv.size // block) * block
    records.append({
        "signal": "complex_sinusoid", "frequency": 4, "phase": np.pi / 4,
        "n_bins": nbins, "input_fft_length": L, "overlap": 0,
        **perf.spectral_performance(inv, nfft),
        "mean_diff": perf.temporal_difference(inp, inv)["mean"],
    })
    module_logger.info("%s", records[-1])

    pos = int(0.1874 * nbins)
    imp = time_domain_impulse(nbins, [pos], [1], dtype=np.complex64)
    inp, inv = round_trip(imp, filt, n_chan, os_f, L, 0, True, device=device)
    records.append({
        "signal": "time_domain_impulse", "impulse_position": pos, "impulse_width": 1,
        "n_bins": nbins, "input_fft_length": L, "overlap": 0,
        **perf.temporal_performance(inv),
        "mean_diff": perf.temporal_difference(inp, inv)["mean"],
    })
    module_logger.info("%s", records[-1])
    return records


STUDIES = {
    "deripple": derippling_effect,
    "overlap": overlap_effect,
    "phase": phase_offset_effect,
    "search": overlap_parameter_search,
    "pipeline": pipeline_study,
}


def report_path(study: str, device) -> str:
    """Where a study's report goes, in the products directory: its name
    carries the device type."""
    tag = torch.device(device).type
    name = (f"report.param_search.{tag}.json" if study == "search"
            else f"param_opt.{study}.{tag}.json")
    return os.path.join(products_dir, name)


def run(argv=None) -> int:
    p = argparse.ArgumentParser(prog="param_opt", description="PFB parameter studies")
    p.add_argument("--study", choices=sorted(STUDIES), default="overlap")
    p.add_argument("--npoints", type=int, default=0,
                   help="frequency points per combination (search study; default = "
                        "the reference's 200)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the round trips (default cuda)")
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)
    kwargs = {"device": a.device}
    if a.study == "search" and a.npoints:
        kwargs["npoints"] = a.npoints
    records = STUDIES[a.study](**kwargs)
    out = report_path(a.study, a.device)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(records, f, cls=NumpyEncoder, indent=2)
    module_logger.info("study written to %s", out)
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
