"""File-level PFB inversion.

The port's counterpart of :mod:`ska_pst_dsp_tpu.data_gen.synthesize`, the
equivalent of python/data_gen/synthesize.py:27-141 and the mcc
``build/synthesize`` executable (synthesize.m:61-113): read a channelized
DADA file, recover the FIR coefficients from its header (COEFF_0 — the
self-describing-file mechanism of add_fir_filter_to_header.m), run the
Golden inversion, write the single-channel DADA file.

Backends as :mod:`.channelize`'s: ``torch`` runs the fused inversion
(:func:`..ops.kernels.synthesis_fused.polyphase_synthesis_fused`: the
frontend kernel, then the epilogue its dispatch picks; a length no plan
splits, such as the 36864 and 41472 points of the critical and LowCBF
inversions, takes the composed epilogue, counted in
``fused_inversion.composed_epilogues``), ``numpy`` the fp64 oracle.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

import numpy as np
import torch

from . import util
from .config import config
from .. import oracle
from ..io import dada
from ..ops.kernels.synthesis_fused import polyphase_synthesis_fused
from ..utils import windows
from ..utils.profiling import StageTimer
from ..utils.rational import Rational

__all__ = ["synthesize", "fft_window_lookup"]

module_logger = logging.getLogger(__name__)


def fft_window_lookup(name: str, fft_length: int, overlap: int) -> np.ndarray:
    """Window factory lookup (synthesize.py:19-24 in the reference maps
    names onto pfb.fft_windows)."""
    return windows.build(name, fft_length, overlap)


@util.partialize
def synthesize(
    input_data_file_path: str,
    input_fft_length: Optional[int] = None,
    input_overlap: Optional[int] = None,
    fft_window_str: str = "tukey",
    apply_deripple: bool = True,
    os_factor_str: Optional[str] = None,
    output_file_name: Optional[str] = None,
    output_dir: str = "./",
    backend: str = "torch",
    spans_nyquist: bool = True,
    combine: int = 1,
    device: str = "cuda",
    timer: Optional[StageTimer] = None,
) -> dada.DADAFile:
    """Invert a channelized DADA file; returns the loaded output DADAFile.
    ``timer`` collects the seconds of its read, compute and write stages."""
    if input_fft_length is None:
        input_fft_length = config.input_fft_length
    if input_overlap is None:
        input_overlap = config.input_overlap
    backend = util.resolve_backend(backend)
    timer = timer or StageTimer(device if backend == "torch" else "cpu")

    with timer.stage("read"):
        data, header = dada.load(input_data_file_path)
    os_factor = Rational.from_str(
        str(os_factor_str) if os_factor_str else header.get("OS_FACTOR", str(config.os_factor))
    )
    stages = dada.get_fir_filters_from_header(header)
    filt = stages[0][0] if stages else config.load_fir_filter_coeff()

    output_base = f"synthesize.{input_fft_length}"
    output_base, log_file_name, output_file_name = util.create_output_file_names(
        output_file_name, output_base
    )
    module_logger.debug(
        "synthesize: %s %s backend=%s L=%d overlap=%d window=%s deripple=%s",
        input_data_file_path, data.shape, backend, input_fft_length,
        input_overlap, fft_window_str, apply_deripple,
    )

    with timer.stage("compute", data.size):
        if backend == "torch":
            x = torch.as_tensor(np.asarray(data, np.complex64), device=device)
            out = polyphase_synthesis_fused(
                x,
                input_fft_length,
                os_factor,
                spans_nyquist=spans_nyquist,
                input_overlap=input_overlap,
                deripple_coeff=filt if apply_deripple else None,
                temporal_taper=fft_window_str,
                combine=combine,
            ).cpu().numpy()
        else:
            taper = fft_window_lookup(fft_window_str, input_fft_length, input_overlap)
            out = oracle.polyphase_synthesis(
                data.astype(np.complex128),
                input_fft_length,
                os_factor,
                spans_nyquist=spans_nyquist,
                input_overlap=input_overlap,
                deripple_coeff=filt if apply_deripple else None,
                temporal_taper=taper.astype(np.float64),
                combine=combine,
            ).astype(np.complex64)

    header = dict(header)
    n_chan_in = data.shape[1]
    tsamp = float(header.get("TSAMP", 1.0))
    header["TSAMP"] = str(tsamp * os_factor.nu / (os_factor.de * n_chan_in))
    header["NSTAGE"] = "0"
    header.pop("OS_FACTOR", None)

    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, output_file_name)
    with timer.stage("write", out.size):
        dada.save(out_path, out, header)
    return dada.DADAFile(out_path).load_data()


def create_parser():
    parser = argparse.ArgumentParser(description="Synthesize (invert) file(s)")
    parser.add_argument("-i", "--input-files", dest="input_file_paths",
                        nargs="+", type=str, required=True)
    parser.add_argument("-f", "--input_fft_length", dest="input_fft_length",
                        type=int, required=True)
    parser.add_argument("-o", "--input_overlap", dest="input_overlap",
                        type=int, default=None)
    parser.add_argument("-w", "--fft_window", dest="fft_window", type=str,
                        default="tukey")
    parser.add_argument("-nd", "--no-deripple", dest="no_deripple",
                        action="store_true")
    parser.add_argument("-b", "--backend", dest="backend", type=str,
                        default="torch")
    parser.add_argument("-od", "--output_dir", dest="output_dir", type=str,
                        default="./")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the torch backend (default: the card)")
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true")
    return parser


def main():
    parsed = create_parser().parse_args()
    logging.basicConfig(level=logging.DEBUG if parsed.verbose else logging.INFO)
    synthesizer = synthesize(backend=parsed.backend.lower(), device=parsed.device)
    for file_path in parsed.input_file_paths:
        synthesizer(
            file_path,
            input_fft_length=parsed.input_fft_length,
            input_overlap=parsed.input_overlap,
            fft_window_str=parsed.fft_window,
            apply_deripple=not parsed.no_deripple,
            output_dir=parsed.output_dir,
            output_file_name="synthesized." + os.path.basename(file_path),
        )


if __name__ == "__main__":
    main()
