"""Dedispersion-invariance verification.

The port's counterpart of :mod:`ska_pst_dsp_tpu.verify.test_dedispersion`,
the equivalent of the reference's python/verify/test_dedispersion.py:54-321:
inversion must commute with coherent dedispersion — dedispersing the
PFB-inverted stream must match dedispersing the original input (the
reference drives dspsr twice, with and without its InverseFilterbank; here
the chirp of :mod:`..ops.dedispersion` fills dspsr's role). Also runs the
folded variant: phase-folded profiles of the two paths must agree.

The channelize → invert path is the port's fused drop-ins on ``device``
(default the card): kernels 1-3 at low, the padded fold, the channel DFT,
the frontend and the out-of-core pair at mid; their plain versions on the
CPU. The inverted stream is aligned with the shift of the analysis it ran
(the zero-padded one at mid). The report lands in
``products/report.dedispersion.<device type>.json``.

    python -m ska_pst_dsp_tpu_torch.verify.test_dedispersion -c low
"""

from __future__ import annotations

import json
import logging
import os
import sys

import numpy as np
import torch

from .. import data_gen
from ..data_gen.config import products_dir
from ..data_gen.util import NumpyEncoder
from ..models.signals import SquareWave
from ..models.testers import PhaseAverage
from ..ops import dedispersion
from ..ops.kernels.analysis_fused import polyphase_analysis_fused
from ..ops.kernels.analysis_padded_fused import polyphase_analysis_padded_fused
from ..ops.kernels.synthesis_fused import polyphase_synthesis_fused
from ..utils import geometry
from .util import dB
from .common import create_parser

module_logger = logging.getLogger(__name__)


def run_dedispersion_test(config, *, dm=None, period_samples=4096,
                          n_bins=None, freq_mhz=1405.0, bw_mhz=40.0,
                          fold_nbin=64, device="cuda"):
    dm = dm if dm is not None else (config.dm or 2.64476)
    if n_bins is None:
        n_bins = (
            config.os_factor.normalize(config.input_fft_length)
            * config.channels * config.blocks * 2
        )
    filt = config.load_fir_filter_coeff()
    os_f = config.os_factor

    # simulated pulsar: dispersed square-wave-modulated noise
    sw = SquareWave(period=period_samples, duty_cycle=0.1, on_amp=4.0,
                    off_amp=0.04, seed=11, device=device)
    clean = sw.generate(0, n_bins)[0, 0]
    dispersed = dedispersion.dedisperse(
        clean[None], dm, freq_mhz, bw_mhz, inverse=True
    )[0].to(torch.complex64)

    # path A: dedisperse the raw stream
    a = dedispersion.dedisperse(dispersed[None], dm, freq_mhz, bw_mhz)[0]

    # path B: channelize -> invert -> dedisperse
    use_padded = config.analysis_function == "polyphase_analysis_padded"
    kern = polyphase_analysis_padded_fused if use_padded else polyphase_analysis_fused
    chan = kern(dispersed[None, None], filt, config.channels, os_f, time_major=True)
    inv = polyphase_synthesis_fused(
        chan, config.input_fft_length, os_f,
        input_overlap=config.input_overlap,
        deripple_coeff=filt if config.deripple else None,
        temporal_taper=config.temporal_taper, time_major_in=True,
    )[0, 0]
    shift = geometry.total_sample_shift(
        config.channels, os_f, config.fir_filter_taps, config.input_overlap,
        padded=use_padded,
    )
    m = (min(inv.shape[0], n_bins - shift) // 2) * 2
    b = dedispersion.dedisperse(inv[:m][None], dm, freq_mhz, bw_mhz)[0].cpu().numpy()
    a_aligned = a[shift: shift + m].cpu().numpy()

    # interior window (outside the chirp's circular wrap region)
    guard = m // 8
    d = np.abs(b[guard:-guard] - a_aligned[guard:-guard]) ** 2
    p = np.abs(a_aligned[guard:-guard]) ** 2
    report = {
        "dm": dm,
        "n_compared": int(d.size),
        "mean_diff_db": float(dB(d.mean() / p.mean())),
        "max_diff_db": float(dB(d.max() / p.max())),
    }

    # folded comparison (dspsr Fold-stage analog)
    fold_freq = 1.0 / period_samples
    profs = []
    for series in (a_aligned[guard:-guard], b[guard:-guard]):
        pa = PhaseAverage(frequency=fold_freq, nbin=fold_nbin)
        st = pa.init_state()
        st = pa.average(st, np.abs(series[None, None, :]) ** 2)
        profs.append(st.result[0, 0].real / np.maximum(st.hits, 1))
    pd = np.abs(profs[0] - profs[1])
    report["folded_mean_diff_db"] = float(
        dB(pd.mean() / max(profs[0].max(), 1e-30))
    )
    return report


def run(argv=None) -> int:
    """The CLI: run the test, write the report, return 0 where the mean
    difference is below -50 dB."""
    parsed = create_parser(
        description="inversion ≡ dedispersion commutation"
    ).parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if parsed.verbose else logging.INFO)
    config = data_gen.config.load_config(parsed.sub_config_name)
    report = run_dedispersion_test(config, device=parsed.device)
    module_logger.info("%s", report)
    os.makedirs(products_dir, exist_ok=True)
    tag = torch.device(parsed.device).type
    with open(os.path.join(products_dir, f"report.dedispersion.{tag}.json"), "w") as f:
        json.dump(report, f, cls=NumpyEncoder, indent=2)
    # reference achieved mean ~ -52..-57 dB on the low config
    return 0 if report["mean_diff_db"] < -50 else 1


def main(argv=None):
    sys.exit(run(argv))


if __name__ == "__main__":
    main()
