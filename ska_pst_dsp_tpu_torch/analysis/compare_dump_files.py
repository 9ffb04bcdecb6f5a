"""General N-file comparison CLI.

The port's copy of :mod:`ska_pst_dsp_tpu.analysis.compare_dump_files` (host
numpy over the port's ``io.dada`` and ``verify.comparator``). Equivalent of
the reference's python/compare_dump_files.py:136-349: load two or more data
files (DADA / .npy / raw binary), slice by pol/chan/sample range, and
compare in time and frequency domains with the comparator framework,
producing metrics and optional plots.

    python -m ska_pst_dsp_tpu_torch.analysis.compare_dump_files a.dump b.dump \
        --pol 0 --fft-size 229376
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np

from ..io import dada
from ..verify import comparator
from ..verify import util as vutil
from ..data_gen.util import NumpyEncoder

module_logger = logging.getLogger(__name__)


def load_any(path: str, dtype: str = "complex64") -> np.ndarray:
    """Load DADA, .npy, or raw binary into (n_pol, n_chan, n_dat)."""
    if path.endswith(".npy"):
        arr = np.load(path)
        while arr.ndim < 3:
            arr = arr[None]
        return arr
    try:
        data, _ = dada.load(path)
        return data
    except (ValueError, KeyError):
        flat = np.fromfile(path, dtype=np.dtype(dtype))
        return flat[None, None, :]


def compare(arrays, *, fft_size=None, labels=None):
    comp = comparator.MultiDomainComparator(
        domains={
            "time": comparator.TimeDomainComparator("time"),
            "freq": comparator.FrequencyDomainComparator("freq"),
        }
    )
    if fft_size:
        comp.freq.domain = [0, fft_size]
    comp.operators["this"] = lambda a: a
    comp.operators["diff"] = lambda a, b: a - b
    comp.products["mean"] = lambda a: float(np.mean(np.abs(a)))
    comp.products["max"] = lambda a: float(np.max(np.abs(a)))
    comp.products["total_spurious"] = vutil.total_spurious
    comp.products["max_spurious"] = vutil.max_spurious
    _, t = comp.time(*arrays)
    _, f = comp.freq(*arrays)
    report = {"time": {}, "freq": {}}
    n = len(arrays)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            report["time"][f"diff_{i}_{j}"] = t["diff"][i, j]
            report["freq"][f"diff_{i}_{j}"] = f["diff"][i, j]
    for i in range(n):
        report["time"][f"this_{i}"] = t["this"][i]
        report["freq"][f"this_{i}"] = f["this"][i]
    return report


def run(argv=None) -> int:
    p = argparse.ArgumentParser(prog="compare_dump_files",
                                description="compare data files")
    p.add_argument("files", nargs="+")
    p.add_argument("--pol", type=int, default=0)
    p.add_argument("--chan", type=int, default=0)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--ndat", type=int, default=0)
    p.add_argument("--fft-size", type=int, default=0)
    p.add_argument("--dtype", default="complex64")
    p.add_argument("--report", default="", help="write JSON report here")
    p.add_argument("--plot", default="", help="write comparison PNG here")
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)

    arrays = []
    for path in a.files:
        d = load_any(path, a.dtype)
        v = d[min(a.pol, d.shape[0] - 1), min(a.chan, d.shape[1] - 1)]
        v = v[a.start: a.start + a.ndat] if a.ndat else v[a.start:]
        arrays.append(v)
        module_logger.info("%s: %s samples", path, v.size)

    report = compare(arrays, fft_size=a.fft_size or None,
                     labels=[os.path.basename(f) for f in a.files])
    for domain in ("time", "freq"):
        for key, prods in report[domain].items():
            if key.startswith("diff"):
                module_logger.info("%s %s: %s", domain, key, prods)
    if a.report:
        with open(a.report, "w") as f:
            json.dump(report, f, cls=NumpyEncoder, indent=2)
    if a.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(len(arrays) + 1, 2, figsize=(12, 3 * (len(arrays) + 1)))
        for i, v in enumerate(arrays):
            axes[i][0].plot(v.real)
            axes[i][0].plot(v.imag)
            axes[i][0].set_title(os.path.basename(a.files[i]))
            axes[i][1].plot(vutil.dB(np.abs(np.fft.fft(v)) ** 2))
            axes[i][1].set_title("power spectrum (dB)")
        d = arrays[0][: min(v.size for v in arrays)] - arrays[1][: min(v.size for v in arrays)]
        axes[-1][0].plot(np.abs(d))
        axes[-1][0].set_title("|difference|")
        axes[-1][1].plot(vutil.dB(np.abs(np.fft.fft(d)) ** 2))
        axes[-1][1].set_title("difference spectrum (dB)")
        fig.tight_layout()
        fig.savefig(a.plot)
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
