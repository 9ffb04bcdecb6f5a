"""Inversion smoke matrix — native analog of the reference's
python/verify/verify_dspsr_pfb_inversion.py:52-110.

The port's counterpart of
:mod:`ska_pst_dsp_tpu.verify.verify_dspsr_pfb_inversion`. The reference
generates 12 unittest methods that drive dspsr's InverseFilterbank over
{single, multi output channel} x {dedispersion after, during inversion} x
{deripple on/off} x {tukey, no_window}. Here the same 12-case matrix runs
the port's fused inversion (:func:`..ops.kernels.synthesis_fused.
polyphase_synthesis_fused`) on ``device`` (default the card):

* "single channel"  — invert the full fine-channel slab to one baseband
  stream (``spans_nyquist=True``).
* "multi channel"   — invert band-ascending groups of fine channels into 16
  coarse output channels (``spans_nyquist=False`` per group), the native
  form of ``dspsr -IF 16:...``. At SKA-Low the 16-channel groups are
  3072-point inversions, for which neither package has an epilogue plan:
  they run the composed epilogue, counted in
  ``fused_inversion.composed_epilogues``. At SKA-Mid the 256-channel groups
  are 114688-point inversions on the out-of-core pair (896 x 128).
* "after dedispersion"  — invert, then apply the coherent-dedispersion chirp
  to the output stream (:func:`..ops.dedispersion.dedisperse`).
* "during dedispersion" — apply the same chirp inside the inversion's
  assembled spectrum (``spectral_filter``, the epilogue kernels' ``elem``)
  — the native form of dspsr's convolution-during-inversion
  (``-IF ... D``).

Each case asserts the during/after agreement, which is strictly stronger
than the reference's run-to-completion check: blockwise convolution during
inversion must equal whole-stream convolution after inversion wherever the
chirp's smearing fits within the overlap-save discard region. The report
lands in ``products/report.verify_pfb_inversion.<device type>.json``; the
drift baseline is the port's own previous report of that name.

    python -m ska_pst_dsp_tpu_torch.verify.verify_dspsr_pfb_inversion -c low
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import sys
from typing import Dict

import numpy as np
import torch

from .. import data_gen
from ..data_gen.config import products_dir
from ..data_gen.util import NumpyEncoder
from ..design.fir import deripple_response
from ..models.signals import SquareWave
from ..ops import dedispersion
from ..ops.kernels.analysis_fused import polyphase_analysis_fused
from ..ops.kernels.analysis_padded_fused import polyphase_analysis_padded_fused
from ..ops.kernels.synthesis_fused import polyphase_synthesis_fused
from ..utils import geometry
from .util import dB
from .common import create_parser

module_logger = logging.getLogger(__name__)

#: (name suffix, multi-channel?, during-dedispersion?, deripple?, window)
CASES = [
    (
        f"{'multi' if multi else 'single'}_channel_"
        f"{'during' if during else 'after'}_dedispersion_"
        f"{'deripple' if drip else 'no_deripple'}_{win}",
        multi,
        during,
        drip,
        win,
    )
    for (drip, win), during, multi in itertools.product(
        [(True, "tukey"), (False, "tukey"), (False, "no_window")],
        (False, True),
        (False, True),
    )
]


def _chirp_pair(n, dm, f0, bw):
    return dedispersion.chirp_filter(n, dm, f0, bw)


def _simulated_pulsar(n_bins, dm, f0, bw, seed=11, device="cuda"):
    sw = SquareWave(period=4096, duty_cycle=0.1, on_amp=4.0, off_amp=0.04,
                    seed=seed, device=device)
    clean = sw.generate(0, n_bins)[0, 0]
    return dedispersion.dedisperse(
        clean[None], dm, f0, bw, inverse=True
    )[0].to(torch.complex64)


def run_case(config, chan, *, multi, deripple, window,
             dm, f0, bw, n_groups=16):
    """Run one (multi, deripple, window) combination on the channelized
    tensor ``chan`` (n_pol, n_chan, n_dat), on its device; returns
    {'mean_diff_db', 'max_diff_db'} between the during- and
    after-dedispersion orderings of the same inversion. Each run computes
    BOTH orderings, so the matrix's during/after case pair shares one
    measurement (noted per-entry in the report via ``shared_with``)."""
    filt = config.load_fir_filter_coeff()
    os_f = config.os_factor
    L = config.input_fft_length
    ov = config.input_overlap
    drip = filt if deripple else None

    def invert(x, spans, spectral_filter=None, deripple_coeff=drip):
        return polyphase_synthesis_fused(
            x, L, os_f,
            spans_nyquist=spans,
            input_overlap=ov,
            deripple_coeff=deripple_coeff,
            temporal_taper=window,
            spectral_filter=spectral_filter,
        )[:, 0]

    if not multi:
        n_chan = chan.shape[1]
        fnw = geometry.SynthesisGeometry(n_chan, L, ov, os_f).fn_width
        h = _chirp_pair(n_chan * fnw, dm, f0, bw)
        a = invert(chan, True)  # after: invert then dedisperse whole stream
        a = dedispersion.dedisperse(a, dm, f0, bw)
        d = invert(chan, True, spectral_filter=h)
        streams = [(a, d, bw)]
    else:
        # band-ascending fine-channel groups -> n_groups coarse channels
        n_chan = chan.shape[1]
        order = np.roll(np.arange(n_chan), n_chan // 2)  # fftshift order
        per = n_chan // n_groups
        bw_c = bw / n_groups
        fnw = geometry.SynthesisGeometry(per, L, ov, os_f).fn_width
        # a group's deripple is the analysis filterbank's per-fine-channel
        # equalization, taken at its n_chan channels; the inversion would take
        # it at the group's `per` (the reciprocal of the filter's stopband), so
        # it rides the spectral filter, one copy per channel (roll 0)
        dr = np.tile(deripple_response(filt, n_chan, fnw // 2), per) if deripple else None
        streams = []
        for g in range(n_groups):
            sel = torch.as_tensor(order[g * per: (g + 1) * per], device=chan.device)
            sub = chan.index_select(1, sel)
            f0_g = f0 - bw / 2 + (g + 0.5) * bw_c
            h = _chirp_pair(per * fnw, dm, f0_g, bw_c)
            a = invert(sub, False, spectral_filter=dr, deripple_coeff=None)
            a = dedispersion.dedisperse(a, dm, f0_g, bw_c)
            d = invert(sub, False, spectral_filter=h if dr is None else h * dr,
                       deripple_coeff=None)
            streams.append((a, d, bw_c))

    worst_mean, worst_max = -np.inf, -np.inf
    for a, d, _ in streams:
        a, d = a.cpu().numpy(), d.cpu().numpy()
        m = min(a.shape[-1], d.shape[-1])
        guard = m // 8
        diff = np.abs(d[..., :m] - a[..., :m])[..., guard:-guard] ** 2
        ref = np.abs(a[..., :m])[..., guard:-guard] ** 2
        worst_mean = max(worst_mean, float(dB(diff.mean() / ref.mean())))
        worst_max = max(worst_max, float(dB(diff.max() / ref.max())))
    return {"mean_diff_db": worst_mean, "max_diff_db": worst_max}


def run_matrix(config, *, dm=None, f0=1405.0, bw=40.0, n_bins=None,
               cases=None, threshold_db=-38.0, device="cuda") -> Dict[str, dict]:
    """Run the 12-case matrix; each case must agree (during ≡ after) to
    ``threshold_db`` mean relative power (the JAX package's −38 dB, ~2 dB
    below its measured −40.2 dB of the single_channel tukey cases)."""
    # a small DM keeps the chirp smearing inside 2*output_overlap in both
    # the full-band and per-group inversions (see module docstring)
    dm = dm if dm is not None else 1.0
    if n_bins is None:
        n_bins = (
            config.os_factor.normalize(config.input_fft_length)
            * config.channels * config.blocks * 2
        )
    filt = config.load_fir_filter_coeff()
    dispersed = _simulated_pulsar(n_bins, dm, f0, bw, device=device)
    use_padded = config.analysis_function == "polyphase_analysis_padded"
    kern = polyphase_analysis_padded_fused if use_padded else polyphase_analysis_fused
    chan = kern(dispersed[None, None], filt, config.channels, config.os_factor)

    report = {}
    memo = {}  # each case runs BOTH orderings and compares them, so the
    # during/after pair of a (multi, deripple, window) combo shares one run
    for name, multi, during, deripple, window in (cases or CASES):
        key = (multi, deripple, window)
        if key not in memo:
            memo[key] = run_case(
                config, chan, multi=multi, deripple=deripple,
                window=window, dm=dm, f0=f0, bw=bw,
            )
        res = dict(memo[key])
        res["ok"] = bool(res["mean_diff_db"] < threshold_db)
        res["shared_with"] = (
            f"{'multi' if multi else 'single'}_channel pair "
            f"({'deripple' if deripple else 'no_deripple'}, {window}): "
            "during/after entries share one during-vs-after measurement"
        )
        report[f"test_{name}"] = res
        module_logger.info("%s: %s", name, res)

    # drift tracking: -38 dB is the hard gate, but warn (and record) when any
    # case degrades >1 dB from the port's previous report on this device type
    tag = torch.device(device).type
    prior_path = os.path.join(products_dir, f"report.verify_pfb_inversion.{tag}.json")
    if os.path.exists(prior_path):
        try:
            with open(prior_path) as f:
                prior = json.load(f)
        except (OSError, json.JSONDecodeError):
            prior = {}
        for name, res in report.items():
            base = prior.get(name, {}).get("mean_diff_db")
            if base is not None:
                res["baseline_mean_diff_db"] = base
                drift = res["mean_diff_db"] - base
                res["drift_db"] = round(drift, 2)
                if drift > 1.0:
                    module_logger.warning(
                        "%s degraded %.2f dB vs recorded baseline "
                        "(%.2f -> %.2f dB)", name, drift, base,
                        res["mean_diff_db"],
                    )
    return report


def run(argv=None) -> int:
    """The CLI: run the matrix, write the report, return 0 where every case
    is ok."""
    parsed = create_parser(
        description="inversion smoke matrix (dspsr -IF analog)"
    ).parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if parsed.verbose else logging.INFO)
    config = data_gen.config.load_config(parsed.sub_config_name)
    report = run_matrix(config, device=parsed.device)
    os.makedirs(products_dir, exist_ok=True)
    tag = torch.device(parsed.device).type
    path = os.path.join(products_dir, f"report.verify_pfb_inversion.{tag}.json")
    with open(path, "w") as f:
        json.dump(report, f, cls=NumpyEncoder, indent=2)
    module_logger.info("wrote %s", path)
    return 0 if all(r["ok"] for r in report.values()) else 1


def main(argv=None):
    sys.exit(run(argv))


if __name__ == "__main__":
    main()
