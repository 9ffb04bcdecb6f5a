"""Backend equivalence verification.

The port's counterpart of :mod:`ska_pst_dsp_tpu.verify.test_backends`, the
equivalent of the reference's python/verify/test_backends.py:28-122 (python
``pfb`` channelizer vs Matlab channelizer on a tone vector, isclose at
1e-4): here the two independent implementations are the port's ``torch``
backend (the CUDA kernels on the card, their plain versions on the CPU) and
the fp64 NumPy oracle, compared through the full file-level pipeline. The
report lands in ``products/report.backends.<device type>.json``.

    python -m ska_pst_dsp_tpu_torch.verify.test_backends -c low [--use-padded]
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
from .common import create_parser

module_logger = logging.getLogger(__name__)

#: fp32 kernel vs fp64 oracle, relative to the output scale (the reference
#: compares two fp32 implementations at atol=rtol=1e-4; ours is tighter)
REL_ATOL = 1e-6
RTOL = 1e-4


def compare_channelizer_backends(config, *, use_padded=False, n_bins=None,
                                 output_dir=None, freq=0.26, device="cuda"):
    out = output_dir or tempfile.mkdtemp()
    if n_bins is None:
        n_bins = (
            config.os_factor.normalize(config.input_fft_length)
            * config.channels * config.blocks
        )
    gen = data_gen.generate_test_vector(
        backend="numpy", domain_name="freq", n_bins=n_bins
    )
    tone = gen([freq], [np.pi / 4], output_dir=out, n_pol=config.n_pol)
    results = {}
    for backend in ("torch", "numpy"):
        f = data_gen.channelize(
            tone.file_path,
            channels=config.channels,
            os_factor_str=str(config.os_factor),
            fir_filter_path=config.fir_filter_path,
            backend=backend,
            use_padded=use_padded,
            output_dir=out,
            output_file_name=f"chan.{backend}.dump",
            device=device,
        )
        results[backend] = f.data
    a, b = results["torch"], results["numpy"]
    scale = float(np.abs(b).max())
    close = np.isclose(a, b, atol=REL_ATOL * scale, rtol=RTOL)
    report = {
        "mean_close": float(close.mean()),
        "max_rel_diff": float(np.abs(a - b).max() / scale),
        "atol": REL_ATOL * scale,
        "n_compared": int(close.size),
        "use_padded": use_padded,
    }
    return report


def run(argv=None) -> int:
    """The CLI: compare, write the report, return 0 where every sample is
    close."""
    parsed = create_parser(
        description="torch-vs-oracle channelizer backend equivalence"
    )
    parsed.add_argument("--use-padded", dest="use_padded",
                        action="store_true")
    a = parsed.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)
    config = data_gen.config.load_config(a.sub_config_name)
    with tempfile.TemporaryDirectory() as out:
        report = compare_channelizer_backends(config, use_padded=a.use_padded,
                                              output_dir=out, device=a.device)
    module_logger.info("backend equivalence: %s", report)
    os.makedirs(products_dir, exist_ok=True)
    tag = torch.device(a.device).type
    with open(os.path.join(products_dir, f"report.backends.{tag}.json"), "w") as f:
        json.dump(report, f, cls=NumpyEncoder, indent=2)
    return 0 if report["mean_close"] == 1.0 else 1


def main(argv=None):
    sys.exit(run(argv))


if __name__ == "__main__":
    main()
