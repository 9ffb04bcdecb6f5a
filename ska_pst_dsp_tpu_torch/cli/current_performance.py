"""current_performance — Golden-model purity sweep.

The port's counterpart of :mod:`ska_pst_dsp_tpu.cli.current_performance`,
the equivalent of the reference's current_performance.m:1-324 +
test_data_pipeline.m:86-151: sweep temporal impulse offsets and tone
frequencies — including adversarial placement at inversion block boundaries
± overlap, where blockwise processing leaks (current_performance.m:60-96) —
through a one-shot generate → analyze → invert pipeline, align with the
config's fir_offset/kludge_offset (chop.m), and score with
DomainPerformance. Backend ``torch`` (the default) runs the fused drop-ins
on ``--device`` (default the card, where the CUDA kernels run); ``numpy``
is the fp64 oracle. Results go to
``<output_dir>/performance.<domain>.<cfg>.<device type>.json`` (default
output_dir: products/; + PNG under ``--plot``, which needs matplotlib), so
the JAX package's committed ``performance.<domain>.<cfg>.json`` stay as they
are.

    python -m ska_pst_dsp_tpu_torch.cli.current_performance -c low -d temporal -n 8
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
from ..ops.kernels.analysis_fused import polyphase_analysis_fused
from ..ops.kernels.analysis_padded_fused import polyphase_analysis_padded_fused
from ..ops.kernels.synthesis_fused import polyphase_synthesis_fused
from ..utils import geometry
from ..utils.config import load_config
from ..verify.util import DomainPerformance
from .. import oracle

module_logger = logging.getLogger(__name__)


def time_domain_offsets(npoints, block_size, nblocks, input_overlap,
                        output_overlap, filt_offset, max_size):
    """Adversarial + uniform impulse positions (current_performance.m:60-74):
    inversion block boundaries, boundaries ± output_overlap, block strides,
    and a uniform sweep."""
    jump = block_size - 2 * output_overlap
    spaced = np.arange(filt_offset, max_size, jump)
    params = np.concatenate([
        spaced,
        spaced[1:] - output_overlap,
        spaced[:-1] + output_overlap,
        np.arange(filt_offset, max_size, block_size),
        np.arange(1, max_size, max(1, round(max_size / npoints))),
    ])
    return np.unique(np.sort(params)).astype(int)


def freq_domain_offsets(npoints, block_size, nblocks):
    """Harmonic numbers: multiples of nblocks stepping through the band
    (current_performance.m:84-96)."""
    return (np.arange(1, block_size, max(1, round(block_size / npoints)))
            * nblocks).astype(int)


def test_data_pipeline(config, signal, *, backend="torch", device="cuda"):
    """One-shot gen → analyze → invert (test_data_pipeline.m:86-144).
    Returns (input (n,), inverted (m,), meta). Backend ``torch`` runs the
    fused drop-ins on ``device``, the analysis handing the inversion its
    time-major spectra on the device; ``numpy`` the fp64 oracle."""
    filt = config.load_fir_filter_coeff()
    os_f = config.os_factor
    use_padded = config.analysis_function == "polyphase_analysis_padded"
    x = signal[None, None, :]
    if backend == "torch":
        kern = polyphase_analysis_padded_fused if use_padded else polyphase_analysis_fused
        chan = kern(torch.as_tensor(x, device=device), filt, config.channels, os_f,
                    time_major=True)
        inv = polyphase_synthesis_fused(
            chan, config.input_fft_length, os_f,
            input_overlap=config.input_overlap,
            deripple_coeff=filt if config.deripple else None,
            temporal_taper=config.temporal_taper, time_major_in=True,
        )[0, 0].cpu().numpy()
    else:
        kern = (oracle.polyphase_analysis_padded if use_padded
                else oracle.polyphase_analysis)
        chan = kern(x.astype(np.complex128), filt, config.channels, os_f)
        from ..utils import windows

        inv = oracle.polyphase_synthesis(
            chan, config.input_fft_length, os_f,
            input_overlap=config.input_overlap,
            deripple_coeff=filt if config.deripple else None,
            temporal_taper=windows.build(
                config.temporal_taper, config.input_fft_length,
                config.input_overlap,
            ).astype(np.float64),
        )[0, 0]
    fir_offset = config.fir_offset_direction * (filt.size // 2)
    meta = {"fir_offset": fir_offset}
    return signal, inv, meta


def chop(config, input_sig, inverted, meta):
    """Align inverted stream against the input (chop.m role). The reference
    aligns via output_overlap + kludge_offset - fir_offset, where
    kludge_offset patches 1-based indexing quirks of its chain; this chain's
    verified alignment is output_overlap + (taps-1)//2 for the non-padded
    analysis and output_overlap - 1 (+ residual) for the padded one, which
    removes its group delay internally (tests/test_mid_production.py)."""
    total = geometry.total_sample_shift(
        config.channels, config.os_factor, config.fir_filter_taps,
        config.input_overlap,
        padded=config.analysis_function == "polyphase_analysis_padded",
    )
    n = min(inverted.size, input_sig.size - total)
    return input_sig[total: total + n], inverted[:n]


def run(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="current_performance", description=__doc__.splitlines()[0]
    )
    p.add_argument("-c", "--config", dest="cfg", default="low")
    p.add_argument("-d", "--domain", default="temporal",
                   choices=["temporal", "spectral", "both"])
    p.add_argument("-n", "--npoints", type=int, default=8)
    p.add_argument("-b", "--backend", default="torch",
                   choices=["torch", "numpy"])
    p.add_argument("--device", default="cuda",
                   help="torch device of the torch backend (default: the card)")
    p.add_argument("--output_dir", default=products_dir)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero if any in-window point exceeds -60 dB")
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)

    config = load_config(a.cfg)
    os_f = config.os_factor
    filt = config.load_fir_filter_coeff()
    block_size = os_f.normalize(config.input_fft_length) * config.channels
    output_overlap = os_f.normalize(config.input_overlap) * config.channels
    nblocks = config.blocks
    n_samples = block_size * nblocks
    filt_offset = (filt.size - 1) // 2 + output_overlap
    perf = DomainPerformance(guard=2)
    os.makedirs(a.output_dir, exist_ok=True)
    tag = torch.device(a.device).type

    domains = ["temporal", "spectral"] if a.domain == "both" else [a.domain]
    report = {}
    for domain in domains:
        results = []
        if domain == "temporal":
            offsets = time_domain_offsets(
                a.npoints, block_size, nblocks, config.input_overlap,
                output_overlap, filt_offset, n_samples,
            )
            shift = geometry.total_sample_shift(
                config.channels, os_f, config.fir_filter_taps,
                config.input_overlap,
                padded=config.analysis_function == "polyphase_analysis_padded",
            )
            for off in offsets:
                sig = time_domain_impulse(n_samples, [int(off)], [1],
                                          dtype=np.complex64)
                inp, inv, meta = test_data_pipeline(config, sig, backend=a.backend,
                                                    device=a.device)
                ichop, vchop = chop(config, inp, inv, meta)
                if vchop.size == 0:
                    continue
                in_window = 0 <= off - shift < vchop.size
                r = perf.temporal_performance(vchop) if in_window else {}
                r.update(perf.temporal_difference(ichop, vchop))
                r["offset"] = int(off)
                r["in_window"] = bool(in_window)
                results.append(r)
                module_logger.info("temporal offset=%d: %s", off, r)
        else:
            freqs = freq_domain_offsets(a.npoints, block_size, nblocks)
            for fq in freqs:
                sig = complex_sinusoid(n_samples, [int(fq)], [np.pi / 4],
                                       dtype=np.complex64)
                inp, inv, meta = test_data_pipeline(config, sig, backend=a.backend,
                                                    device=a.device)
                ichop, vchop = chop(config, inp, inv, meta)
                if vchop.size == 0:
                    continue
                # measure over a multiple of block_size so the swept tones
                # (multiples of nblocks over nblocks*block_size samples) are
                # exact bins — otherwise scalloping loss masks the purity
                nfft = (vchop.size // block_size) * block_size
                r = perf.spectral_performance(vchop, nfft)
                r.update(perf.temporal_difference(ichop, vchop))
                r["frequency"] = int(fq)
                results.append(r)
                module_logger.info("spectral freq=%d: %s", fq, r)
        report[domain] = results

        if a.plot and results:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            key = "offset" if domain == "temporal" else "frequency"
            fig, ax = plt.subplots()
            xs = [r[key] for r in results]
            ax.plot(xs, [r["max_spurious"] for r in results], "o-",
                    label="max spurious")
            ax.plot(xs, [r["total_spurious"] for r in results], "s-",
                    label="total spurious")
            ax.axhline(-60, color="r", ls="--", label="-60 dB requirement")
            ax.set_xlabel(key)
            ax.set_ylabel("dB")
            ax.legend()
            fig.savefig(os.path.join(
                a.output_dir, f"performance.{domain}.{a.cfg}.{tag}.png"
            ))

    out = os.path.join(a.output_dir, f"performance.{a.domain}.{a.cfg}.{tag}.json")
    with open(out, "w") as f:
        json.dump(report, f, cls=NumpyEncoder, indent=2)
    module_logger.info("performance report written to %s", out)

    worst = max(
        (r["max_spurious"] for rs in report.values() for r in rs
         if "max_spurious" in r and r.get("in_window", True)),
        default=-np.inf,
    )
    module_logger.info("worst in-window max_spurious: %.1f dB (req -60)", worst)
    if a.strict:
        return 0 if worst < -60 else 1
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
