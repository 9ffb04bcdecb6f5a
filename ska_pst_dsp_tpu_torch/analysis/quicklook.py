"""Generic quick-look plotting of binary / DADA files.

The port's copy of :mod:`ska_pst_dsp_tpu.analysis.quicklook` (host numpy
and matplotlib, no ops). Equivalents of the reference operator tools
python/plot_binary_file.py:1-90 (re/im traces of raw binary or .npy files)
and plot_dada_file.py:1-37 (per-pol amplitude trace for single-channel
files, channel waterfall for channelized files). Headless environments
save PNGs next to the input (``--save``/no display) instead of blocking on
plt.show().

Run:
    python -m ska_pst_dsp_tpu_torch.analysis.quicklook dada <file.dump> [--save]
    python -m ska_pst_dsp_tpu_torch.analysis.quicklook binary -i f1 f2 -dt complex64
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

module_logger = logging.getLogger(__name__)

#: name -> numpy dtype (compare_dump_files.py dtype_map role)
dtype_map = {
    "float32": np.float32,
    "float64": np.float64,
    "complex64": np.complex64,
    "complex128": np.complex128,
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
}


def load_binary_data(path: str, dtype=np.complex64, offset: int = 0):
    """Flat binary reader (compare_dump_files.load_binary_data role)."""
    with open(path, "rb") as f:
        f.seek(offset)
        return np.frombuffer(f.read(), dtype=dtype)


def _get_axes(plt, nrows, ncols):
    fig, axes = plt.subplots(nrows, ncols, squeeze=False, figsize=(10, 3 * nrows))
    return fig, axes


def plot_binary_files(*file_paths: str, dtype=None, offset: int = 0,
                      save: bool = True, out_path: str = ""):
    """Stacked re/im traces of each file (plot_binary_file.py:13-45)."""
    if dtype is None:
        raise RuntimeError("Have to specify a data type")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = []
    for f in file_paths:
        if f.endswith(".npy"):
            data.append(np.load(f).ravel())
        else:
            data.append(load_binary_data(f, dtype=dtype, offset=offset))

    iscomplex = np.iscomplexobj(data[0])
    comps = [np.real, np.imag] if iscomplex else [np.real]
    fig, axes = _get_axes(plt, len(file_paths), len(comps))
    for i, (f, d) in enumerate(zip(file_paths, data)):
        for z, fn in enumerate(comps):
            ax = axes[i][z]
            ax.grid(True)
            ax.set_title(
                f"{os.path.basename(f)} ({'re' if z == 0 else 'im'})",
                fontsize=8,
            )
            ax.plot(fn(d))
    fig.tight_layout()
    out = out_path or (file_paths[0] + ".quicklook.png")
    fig.savefig(out)
    module_logger.info("wrote %s", out)
    if not save:
        plt.show()
    return out


def plot_dada_file(file_path: str, save: bool = True, out_path: str = ""):
    """Per-pol amplitude trace (1 channel) or channel waterfall
    (plot_dada_file.py:9-34)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..io import dada

    dada_file = dada.DADAFile(file_path).load_data()
    data = dada_file.data  # (ndat, nchan, npol)
    nchan, npol = data.shape[1], data.shape[2]

    fig, axes = _get_axes(plt, npol, 1)
    for ipol in range(npol):
        ax = axes[ipol][0]
        ax.set_title(f"Polarization {ipol}")
        ax.set_xlabel("Samples")
        if nchan == 1:
            ax.plot(np.abs(data[:, 0, ipol]))
            ax.set_ylabel("Amplitude")
        else:
            ax.imshow(np.abs(data[:, :, ipol].T), aspect="auto",
                      origin="lower")
            ax.set_ylabel("Channels")
    fig.tight_layout()
    out = out_path or (file_path + ".quicklook.png")
    fig.savefig(out)
    module_logger.info("wrote %s", out)
    if not save:
        plt.show()
    return out


def create_parser():
    p = argparse.ArgumentParser(
        prog="quicklook", description="quick-look file plots"
    )
    sub = p.add_subparsers(dest="mode", required=True)

    pb = sub.add_parser("binary", help="plot raw binary / .npy file(s)")
    pb.add_argument("-i", "--input-files", dest="input_file_paths",
                    nargs="+", type=str, required=True)
    pb.add_argument("-dt", "--dtype", dest="dtype", type=str,
                    default="complex64",
                    help=f"one of {sorted(dtype_map)}")
    pb.add_argument("--offset", type=int, default=0,
                    help="byte offset of the data in the file")
    pb.add_argument("-o", "--output", default="")

    pd = sub.add_parser("dada", help="plot a DADA file")
    pd.add_argument("file", type=str)
    pd.add_argument("-o", "--output", default="")

    p.add_argument("-v", "--verbose", action="store_true")
    return p


def run(argv=None) -> int:
    a = create_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if getattr(a, "verbose", False) else logging.INFO
    )
    logging.getLogger("matplotlib").setLevel(logging.ERROR)
    if a.mode == "binary":
        plot_binary_files(
            *a.input_file_paths, dtype=dtype_map[a.dtype], offset=a.offset,
            out_path=a.output,
        )
    else:
        plot_dada_file(a.file, out_path=a.output)
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
