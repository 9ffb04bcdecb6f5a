"""Test-vector tree walker and 3-way inversion report.

The port's counterpart of :mod:`ska_pst_dsp_tpu.analysis.process_test_vectors`.
Equivalent of python/process_test_vectors.py:1-180 + iter_test_vectors.py:
walk the on-disk test-vector tree ``{base}/{time,freq}/<param-subdir>/``
(the same layout ``data_gen.util.find_existing_test_data`` reads), close
the loop with an INDEPENDENT inversion of each vector's channelized data,
and emit the 3-way (input / model-inverted / independent-inverted)
comparison report plus a summary plot. The tree is generated through the
port's ``data_gen`` on the ``torch`` backend (the CUDA kernels on
``--device``, default the card); the report lands in
``products/report.process_test_vectors.<device type>.json``.

Where the reference shells out to dspsr (run_dspsr_with_dump) for the
independent inversion, this framework uses its loop-faithful fp64 NumPy
oracle (``backend="numpy"`` through data_gen.synthesize) — the same role
stand-in the rest of the verify layer uses when dspsr binaries are absent.
If a dspsr binary IS present, ``--independent dspsr`` routes through
data_gen.dspsr_util instead.

Run:
    python -m ska_pst_dsp_tpu_torch.analysis.process_test_vectors --generate -n 4
    python -m ska_pst_dsp_tpu_torch.analysis.process_test_vectors
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import typing

import numpy as np
import torch

from .. import data_gen
from ..data_gen.config import products_dir
from ..data_gen.util import NumpyEncoder, meta_data_file_name
from ..utils import geometry
from ..utils.config import load_config
from ..verify import comparator
from ..verify.util import dB

module_logger = logging.getLogger(__name__)

#: subdir name formats (data_gen.util.find_existing_test_data)
_SUBDIR_FMT = {
    "time": "o-{offset:.3f}_w-{width:.3f}",
    "freq": "f-{frequency:.3f}_b-{bin_offset:.3f}_p-{phase:.3f}",
}
_KEY_MAP = {"time": "impulse_position", "freq": "freq_position"}


def iter_test_vectors(
    base_dir: str,
    domain_sub_dirs: typing.Optional[typing.List[str]] = None,
):
    """Yield (domain, sub_dir) for every vector directory under base_dir
    (iter_test_vectors.py:5-23)."""
    if domain_sub_dirs is None:
        domain_sub_dirs = sorted(
            d for d in os.listdir(base_dir)
            if os.path.isdir(os.path.join(base_dir, d))
        )
    for domain in domain_sub_dirs:
        sub_dir = os.path.join(base_dir, domain)
        for sub_sub_dir in sorted(os.listdir(sub_dir)):
            full = os.path.join(sub_dir, sub_sub_dir)
            if os.path.isdir(full):
                yield domain, full


def generate_tree(config, base_dir: str, n_test: int = 4, device: str = "cuda") -> int:
    """Populate the tree: for each parameter, generate -> channelize ->
    model-invert (the ``torch`` backend on ``device``, with the config's
    own filter) into its own subdirectory with a meta.json naming every
    product (the layout process_test_vectors consumes)."""
    os_factor = config.os_factor
    block_size = os_factor.normalize(config.input_fft_length) * config.channels
    n_samples = block_size * config.blocks
    use_padded = config.analysis_function == "polyphase_analysis_padded"
    shift = geometry.total_sample_shift(
        config.channels, os_factor, config.fir_filter_taps,
        config.input_overlap, padded=use_padded,
    )

    gen = data_gen.generate_test_vector(backend="torch", n_bins=n_samples)
    chan = data_gen.channelize(
        backend="torch", channels=config.channels,
        os_factor_str=str(os_factor), use_padded=use_padded,
        fir_filter_path=config.fir_filter_path, device=device,
    )
    synth = data_gen.synthesize(
        backend="torch", apply_deripple=config.deripple,
        fft_window_str=config.temporal_taper,
        input_fft_length=config.input_fft_length,
        input_overlap=config.input_overlap, device=device,
    )

    params = {
        "time": [
            {"offset": float(o), "width": 1.0}
            for o in np.linspace(shift + 10, n_samples * 0.9, n_test)
        ],
        "freq": [
            {"frequency": float(f), "bin_offset": 0.0, "phase": np.pi / 4}
            for f in (np.linspace(1, block_size, n_test) * config.blocks)
        ],
    }
    count = 0
    for domain, plist in params.items():
        for p in plist:
            sub_dir = os.path.join(base_dir, domain, _SUBDIR_FMT[domain].format(**p))
            os.makedirs(sub_dir, exist_ok=True)
            if domain == "time":
                in_file = gen(
                    int(p["offset"]), p["width"], domain_name="time",
                    output_dir=sub_dir,
                )
            else:
                in_file = gen(
                    int(p["frequency"]), p["phase"], p["bin_offset"],
                    domain_name="freq", output_dir=sub_dir,
                )
            base = os.path.basename(in_file.file_path)
            chan_file = chan(
                in_file.file_path, output_dir=sub_dir,
                output_file_name="channelized." + base,
            )
            inv_file = synth(
                chan_file.file_path, output_dir=sub_dir,
                output_file_name="inverted." + base,
            )
            meta = {
                "input_file": base,
                "channelized_file": os.path.basename(chan_file.file_path),
                "inverted_file": os.path.basename(inv_file.file_path),
                _KEY_MAP[domain]: p.get("offset", p.get("frequency")),
                "config": config.name,
            }
            with open(os.path.join(sub_dir, meta_data_file_name), "w") as f:
                json.dump(meta, f, cls=NumpyEncoder, indent=2)
            count += 1
            module_logger.info("generated %s", sub_dir)
    return count


def _chop(config, input_dat, inverted_dat):
    use_padded = config.analysis_function == "polyphase_analysis_padded"
    shift = geometry.total_sample_shift(
        config.channels, config.os_factor, config.fir_filter_taps,
        config.input_overlap, padded=use_padded,
    )
    a = input_dat[shift:]
    n = min(a.size, inverted_dat.size)
    return a[:n], inverted_dat[:n]


def process_test_vectors(
    base_dir: str,
    *,
    independent: str = "numpy",
    fft_size: int = 16384,
    plot: bool = True,
    config_name: typing.Optional[str] = None,
    device: str = "cuda",
) -> dict:
    """Close the loop over the tree: independently invert each vector's
    channelized file and 3-way compare (process_test_vectors.py:131-180).
    ``device`` names the report (its device type: the tree's inversions ran
    there); the independent inversion runs on the host."""
    comp = comparator.MultiDomainComparator(
        domains={
            "time": comparator.TimeDomainComparator("time"),
            "freq": comparator.FrequencyDomainComparator("freq"),
        }
    )
    comp.freq.domain = [0, fft_size]
    comp.operators["this"] = lambda a: a
    comp.operators["diff"] = lambda a, b: np.abs(a - b)
    comp.products["mean"] = lambda a: np.mean(np.abs(a))
    comp.products["max"] = lambda a: np.amax(np.abs(a))

    report: dict = {"time": [], "freq": []}
    for domain, sub_dir in iter_test_vectors(base_dir):
        meta_path = os.path.join(sub_dir, meta_data_file_name)
        if not os.path.exists(meta_path):
            module_logger.warning("no %s in %s; skipping", meta_data_file_name,
                                  sub_dir)
            continue
        with open(meta_path) as f:
            meta = json.load(f)
        config = load_config(meta.get("config", config_name or "low"))

        # the independent inversion of the recorded channelized data
        if independent == "dspsr":
            from ..data_gen import dspsr_util

            dump = dspsr_util.run_dspsr_with_dump(
                os.path.join(sub_dir, meta["channelized_file"]),
                dm=config.dm or 2.64476, period=config.period or 0.00575745,
                output_dir=sub_dir,
            )[1]
            indep_path = dump
        else:
            synth = data_gen.synthesize(
                backend="numpy", apply_deripple=config.deripple,
                fft_window_str=config.temporal_taper,
                input_fft_length=config.input_fft_length,
                input_overlap=config.input_overlap,
            )
            indep = synth(
                os.path.join(sub_dir, meta["channelized_file"]),
                output_dir=sub_dir,
                output_file_name="independent." + meta["input_file"],
            )
            indep_path = indep.file_path
        meta["independent_file"] = os.path.basename(indep_path)
        with open(meta_path, "w") as f:
            json.dump(meta, f, cls=NumpyEncoder, indent=2)

        from ..io import dada

        inp = dada.DADAFile(
            os.path.join(sub_dir, meta["input_file"])).load_data()
        inv = dada.DADAFile(
            os.path.join(sub_dir, meta["inverted_file"])).load_data()
        ind = dada.DADAFile(indep_path).load_data()

        in_dat = inp.data[:, 0, 0].ravel()
        inv_dat = inv.data[:, 0, 0].ravel()
        ind_dat = ind.data[:, 0, 0].ravel()
        a, b = _chop(config, in_dat, inv_dat)
        _, c = _chop(config, in_dat, ind_dat)
        n = min(a.size, b.size, c.size)
        a, b, c = a[:n], b[:n], c[:n]

        labels = ["input", "inverted", "independent_inverted"]
        _, prod_time = comp.time(a, b, c)
        _, prod_freq = comp.freq(a / fft_size, b / fft_size, c / fft_size)

        entry = {
            _KEY_MAP[domain]: meta.get(_KEY_MAP[domain]),
            "sub_dir": os.path.relpath(sub_dir, base_dir),
            "labels": labels,
            # diff matrices: [i][j] = products of |arr_i - arr_j|
            "time_mean_diff": {
                "inverted_vs_input": prod_time["diff"][1, 0]["mean"],
                "independent_vs_input": prod_time["diff"][2, 0]["mean"],
                "independent_vs_inverted": prod_time["diff"][2, 1]["mean"],
            },
            "freq_mean_diff": {
                "inverted_vs_input": prod_freq["diff"][1, 0]["mean"],
                "independent_vs_input": prod_freq["diff"][2, 0]["mean"],
                "independent_vs_inverted": prod_freq["diff"][2, 1]["mean"],
            },
        }
        report[domain].append(entry)
        module_logger.info("%s: %s", sub_dir, entry["time_mean_diff"])

    tag = torch.device(device).type
    os.makedirs(products_dir, exist_ok=True)
    out = os.path.join(products_dir, f"report.process_test_vectors.{tag}.json")
    with open(out, "w") as f:
        json.dump(report, f, cls=NumpyEncoder, indent=2)
    module_logger.info("wrote %s", out)

    if plot and any(report.values()):
        _report_plot(report, tag)
    return report


def _report_plot(report: dict, tag: str):
    """Summary scatter: 3-way mean differences vs feature position
    (process_test_vectors.py:create_report_plot role)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, domain in zip(axes, ("time", "freq")):
        rows = report.get(domain, [])
        if not rows:
            ax.set_visible(False)
            continue
        xs = [r[_KEY_MAP[domain]] for r in rows]
        for pair in ("inverted_vs_input", "independent_vs_input",
                     "independent_vs_inverted"):
            ys = [
                dB(max(r["time_mean_diff"][pair], 1e-30) ** 2) for r in rows
            ]
            ax.plot(xs, ys, "o-", label=pair)
        ax.set_xlabel(_KEY_MAP[domain])
        ax.set_ylabel("mean |diff|^2 [dB]")
        ax.set_title(domain)
        ax.legend(fontsize=7)
    fig.tight_layout()
    path = os.path.join(products_dir, f"process_test_vectors.{tag}.png")
    fig.savefig(path)
    module_logger.info("wrote %s", path)


def run(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="process_test_vectors", description=__doc__.splitlines()[0]
    )
    p.add_argument("-c", "--config", default="low")
    p.add_argument("-b", "--base-dir", default=None,
                   help="tree root (default data/test_vectors)")
    p.add_argument("--generate", action="store_true",
                   help="populate the tree before processing")
    p.add_argument("-n", "--n-test", type=int, default=4)
    p.add_argument("--independent", default="numpy",
                   choices=["numpy", "dspsr"])
    p.add_argument("--fft-size", type=int, default=16384)
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the tree's inversions (default: the card)")
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)

    config = load_config(a.config)
    base_dir = a.base_dir or os.path.join(
        data_gen.config.config.data_dir, "test_vectors"
    )
    if a.generate:
        os.makedirs(base_dir, exist_ok=True)
        n = generate_tree(config, base_dir, n_test=a.n_test, device=a.device)
        module_logger.info("generated %d vector directories", n)
    report = process_test_vectors(
        base_dir, independent=a.independent, fft_size=a.fft_size,
        plot=not a.no_plot, config_name=a.config, device=a.device,
    )
    ok = all(
        r["time_mean_diff"]["independent_vs_inverted"] < 1e-4
        for rows in report.values() for r in rows
    )
    return 0 if ok and any(report.values()) else 1


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
