"""Cross-implementation inversion equivalence.

The port's counterpart of
:mod:`ska_pst_dsp_tpu.verify.test_cross_implementation`, the equivalent of
the reference's python/verify/test_matlab_dspsr_pfb_inversion.py:29-352
(Matlab Golden ≡ dspsr InverseFilterbank at atol=rtol=1e-6, mean fraction
1.0): the same test vector is channelized once (``torch``) and inverted
through the port's two independent implementations (the ``torch`` backend:
the CUDA kernels on the card, their plain versions on the CPU; and the fp64
NumPy oracle); every sample must agree. Variants: impulse, sinusoid,
simulated pulsar (square-wave-modulated noise). The report lands in
``products/report.cross_impl.<device type>.json``.

    python -m ska_pst_dsp_tpu_torch.verify.test_cross_implementation -c low -t -f
"""

from __future__ import annotations

import json
import logging
import os
import sys
import tempfile

import numpy as np
import torch

from .. import data_gen
from ..data_gen.config import products_dir
from ..data_gen.util import NumpyEncoder
from ..io import dada
from ..models.signals import SquareWave
from .common import create_parser

module_logger = logging.getLogger(__name__)

ATOL = RTOL = 1e-6  # test_matlab_dspsr_pfb_inversion.py:35


def _compare_inversions(config, vector_file, out_dir, device="cuda"):
    chan = data_gen.channelize(
        vector_file,
        channels=config.channels,
        os_factor_str=str(config.os_factor),
        fir_filter_path=config.fir_filter_path,
        backend="torch",
        use_padded=config.analysis_function == "polyphase_analysis_padded",
        output_dir=out_dir,
        output_file_name="chan.dump",
        device=device,
    )
    inv = {}
    for backend in ("torch", "numpy"):
        f = data_gen.synthesize(
            chan.file_path,
            input_fft_length=config.input_fft_length,
            input_overlap=config.input_overlap,
            fft_window_str=config.temporal_taper,
            apply_deripple=config.deripple,
            backend=backend,
            output_dir=out_dir,
            output_file_name=f"inv.{backend}.dump",
            device=device,
        )
        inv[backend] = f.data
    a, b = inv["torch"], inv["numpy"]
    scale = max(np.abs(b).max(), 1e-30)
    close = np.isclose(a, b, atol=ATOL * scale, rtol=RTOL)
    return {
        "mean": float(close.mean()),
        "sum": int(close.sum()),
        "n": int(close.size),
        "max_rel_diff": float(np.abs(a - b).max() / scale),
    }


def run_suite(config, n_bins=None, do_time=True, do_freq=True,
              do_pulsar=True, output_dir=None, *, offset=0.11, freq=0.11,
              device="cuda"):
    """The three variants; ``offset`` and ``freq`` place the impulse and the
    tone (fractions of ``n_bins`` below 1, else sample and bin indices)."""
    out = output_dir or tempfile.mkdtemp()
    os.makedirs(out, exist_ok=True)
    if n_bins is None:
        n_bins = (
            config.os_factor.normalize(config.input_fft_length)
            * config.channels * config.blocks
        )
    report = {}
    if do_time:
        gen = data_gen.generate_test_vector(
            backend="numpy", domain_name="time", n_bins=n_bins
        )
        f = gen([offset], [1], output_dir=out, n_pol=config.n_pol)
        report["test_time_domain_impulse"] = [
            {"offset": offset, **_compare_inversions(config, f.file_path, out, device)}
        ]
    if do_freq:
        gen = data_gen.generate_test_vector(
            backend="numpy", domain_name="freq", n_bins=n_bins
        )
        f = gen([freq], [np.pi / 4], output_dir=out, n_pol=config.n_pol)
        report["test_complex_sinusoid"] = [
            {"freq": freq, **_compare_inversions(config, f.file_path, out, device)}
        ]
    if do_pulsar:
        # simulated pulsar: square-wave-modulated noise (the checked-in
        # simulated_pulsar dump of the reference, regenerated)
        sw = SquareWave(period=1024, duty_cycle=0.1, on_amp=4.0, off_amp=0.25,
                        seed=3, device=device)
        x = sw.generate(0, n_bins).cpu().numpy()
        x = np.repeat(x, config.n_pol, axis=0)
        path = os.path.join(out, "simulated_pulsar.dump")
        hdr = config.load_header()
        dada.save(path, x, hdr)
        report["test_simulated_pulsar"] = [
            _compare_inversions(config, path, out, device)
        ]
    return report


def run(argv=None) -> int:
    """The CLI: run the suite, write the report, return 0 where every
    variant's mean fraction is above 0.999."""
    parsed = create_parser(
        description="torch ≡ oracle PFB inversion equivalence"
    ).parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if parsed.verbose else logging.INFO)
    config = data_gen.config.load_config(parsed.sub_config_name)
    do_all = not (parsed.do_time or parsed.do_freq)
    with tempfile.TemporaryDirectory() as out:
        report = run_suite(
            config,
            do_time=parsed.do_time or do_all,
            do_freq=parsed.do_freq or do_all,
            do_pulsar=do_all,
            output_dir=out,
            device=parsed.device,
        )
    module_logger.info("%s", json.dumps(report, indent=2, cls=NumpyEncoder))
    os.makedirs(products_dir, exist_ok=True)
    tag = torch.device(parsed.device).type
    with open(os.path.join(products_dir, f"report.cross_impl.{tag}.json"), "w") as f:
        json.dump(report, f, cls=NumpyEncoder, indent=2)
    ok = all(e["mean"] > 0.999 for rs in report.values() for e in rs)
    return 0 if ok else 1


def main(argv=None):
    sys.exit(run(argv))


if __name__ == "__main__":
    main()
