"""File-level channelization.

The port's counterpart of :mod:`ska_pst_dsp_tpu.data_gen.channelize`, the
equivalent of python/data_gen/channelize.py:19-142 and the mcc
``build/channelize`` executable (channelize.m:61-111): read a single-channel
DADA file, run the analysis PFB, write the channelized DADA file with
updated TSAMP/OS_FACTOR/PFB headers.

Backends (:func:`.util.resolve_backend`): ``torch`` (the default) runs the
fused drop-ins, so on the card (``device="cuda"``, the default) the analysis
kernels run, and on the CPU their plain versions; ``numpy`` is the fp64
oracle. The reference's ``matlab``/``python`` names alias to ``numpy``.
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
from ..ops.kernels.analysis_fused import polyphase_analysis_fused
from ..ops.kernels.analysis_padded_fused import polyphase_analysis_padded_fused
from ..utils.profiling import StageTimer
from ..utils.rational import Rational

__all__ = ["channelize"]

module_logger = logging.getLogger(__name__)


@util.partialize
def channelize(
    input_data_file_path: str,
    channels: Optional[int] = None,
    os_factor_str: Optional[str] = None,
    fir_filter_path: Optional[str] = None,
    output_file_name: Optional[str] = None,
    output_dir: str = "./",
    backend: str = "torch",
    use_padded: bool = False,
    device: str = "cuda",
    timer: Optional[StageTimer] = None,
) -> dada.DADAFile:
    """Channelize a single-channel DADA file; returns the loaded output
    DADAFile (same call surface as the reference factory). ``timer``
    collects the seconds of its read, compute and write stages."""
    from ..design.fir import read_fir_filter_coeff

    if channels is None:
        channels = config.channels
    if os_factor_str is None:
        os_factor_str = str(config.os_factor)
    os_factor = Rational.from_str(str(os_factor_str))
    if fir_filter_path is None:
        fir_filter_path = config.fir_filter_path
    if not os.path.exists(fir_filter_path):
        # design on demand through the config machinery
        filt = config.load_fir_filter_coeff()
    else:
        filt = read_fir_filter_coeff(fir_filter_path)

    backend = util.resolve_backend(backend)
    output_base = f"channelize.{channels}.{'-'.join(str(os_factor_str).split('/'))}"
    output_base, log_file_name, output_file_name = util.create_output_file_names(
        output_file_name, output_base
    )
    timer = timer or StageTimer(device if backend == "torch" else "cpu")

    with timer.stage("read"):
        data, header = dada.load(input_data_file_path)
    module_logger.debug(
        "channelize: %s %s backend=%s channels=%d os=%s padded=%s",
        input_data_file_path, data.shape, backend, channels, os_factor, use_padded,
    )

    with timer.stage("compute", data.shape[0] * data.shape[2]):
        if backend == "torch":
            kern = polyphase_analysis_padded_fused if use_padded else polyphase_analysis_fused
            x = torch.as_tensor(np.asarray(data, np.complex64), device=device)
            out = kern(x, filt, channels, os_factor).cpu().numpy()
        else:
            kern = (
                oracle.polyphase_analysis_padded
                if use_padded
                else oracle.polyphase_analysis
            )
            out = kern(data.astype(np.complex128), filt, channels, os_factor).astype(
                np.complex64
            )

    # header surgery (channelize.m:79-97): fine channels are n_chan times
    # slower, scaled by de/nu for oversampling
    header = dict(header)
    tsamp = float(header.get("TSAMP", 1.0))
    header["TSAMP"] = str(tsamp * channels * os_factor.de / os_factor.nu)
    header["OS_FACTOR"] = str(os_factor)
    header["PFB_DC_CHAN"] = "1"
    header["NSTAGE"] = "1"
    header["NCHAN_PFB_0"] = str(channels)
    header["PFB_NCHAN"] = str(channels)
    header = dada.add_fir_filter_to_header(header, filt, os_factor)

    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, output_file_name)
    with timer.stage("write", out.size):
        dada.save(out_path, out, header)
    return dada.DADAFile(out_path).load_data()


def create_parser():
    parser = argparse.ArgumentParser(description="Channelize file(s)")
    parser.add_argument("-i", "--input-files", dest="input_file_paths",
                        nargs="+", type=str, required=True)
    parser.add_argument("-c", "--channels", dest="channels", type=int,
                        required=True)
    parser.add_argument("-osf", "--os_factor", dest="os_factor", type=str,
                        required=True)
    parser.add_argument("-b", "--backend", dest="backend", type=str,
                        default="torch", help="torch or numpy")
    parser.add_argument("-od", "--output_dir", dest="output_dir", type=str,
                        default="./")
    parser.add_argument("-p", "--use-padded", dest="use_padded",
                        action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the torch backend (default: the card)")
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true")
    return parser


def main():
    parsed = create_parser().parse_args()
    logging.basicConfig(level=logging.DEBUG if parsed.verbose else logging.INFO)
    channelizer = channelize(backend=parsed.backend.lower(), device=parsed.device)
    for file_path in parsed.input_file_paths:
        channelizer(
            file_path,
            channels=parsed.channels,
            os_factor_str=parsed.os_factor,
            output_dir=parsed.output_dir,
            output_file_name="channelized." + os.path.basename(file_path),
            use_padded=parsed.use_padded,
        )


if __name__ == "__main__":
    main()
