"""On-card purity sweep through the port's CUDA kernel chain.

The −60 dB purity gates (TestPureTone.m:20, TestImpulse.m:26 in the
reference; CSP_Low_PST_REQ-627/697, CSP_Mid_PST_REQ-385/386) run the
temporal (impulse) and spectral (tone) sweeps — with the adversarial
block-boundary ± overlap placement of current_performance.m:60-96 —
through the hand-written CUDA kernels of ``ska_pst_dsp_tpu_torch`` on the
card, the chains ``chip_smoke.py`` times:

  low: analysis_fused → synthesis_fused → the cluster epilogue (ifft_fused),
       the time-major keep_padding/valid_len handoff;
  mid: analysis_padded_fused (production 100353-tap filter) → chan_dft_fused
       → synthesis_fused → the out-of-core pair (ifft_big, 1.8M points).

Writes products/report.purity.cuda.<cfg>.json with the card's name and
power limit (``nvidia-smi``), per-point max/total spurious dB, the worst
in-window value and the gate verdict. Exits non-zero if any in-window point
exceeds −60 dB. It runs on the card only.

    python tools/purity_cuda.py -c low -n 16
    python tools/purity_cuda.py -c mid -n 6
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

from ska_pst_dsp_tpu_torch.cli.current_performance import (  # noqa: E402
    chop, freq_domain_offsets, time_domain_offsets,
)
from ska_pst_dsp_tpu_torch.data_gen.config import products_dir  # noqa: E402
from ska_pst_dsp_tpu_torch.data_gen.generate_test_vector import (  # noqa: E402
    complex_sinusoid, time_domain_impulse,
)
from ska_pst_dsp_tpu_torch.data_gen.util import NumpyEncoder  # noqa: E402
from ska_pst_dsp_tpu_torch.utils import geometry  # noqa: E402
from ska_pst_dsp_tpu_torch.utils.config import load_config  # noqa: E402
from ska_pst_dsp_tpu_torch.verify.util import DomainPerformance  # noqa: E402


def card_name() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def fused_pipeline(config, filt, device="cuda"):
    """The kernel chain's forward for a config, on ``device``: a (n,)
    signal in, the inverted (m,) complex128 stream out. On a CPU device it
    runs the kernels' plain versions (the tests' check of the plumbing)."""
    import torch

    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import (
        polyphase_synthesis_fused,
    )

    os_f = config.os_factor
    n_chan = config.channels
    use_padded = config.analysis_function == "polyphase_analysis_padded"
    deripple = filt if config.deripple else None
    kw = dict(input_overlap=config.input_overlap, deripple_coeff=deripple,
              temporal_taper=config.temporal_taper, time_major_in=True)

    if use_padded:
        from ska_pst_dsp_tpu_torch.ops.kernels.analysis_padded_fused import (
            polyphase_analysis_padded_fused,
        )

        def forward(xr, xi):
            cr, ci = polyphase_analysis_padded_fused(
                (xr, xi), filt, n_chan, os_f, time_major=True)
            return polyphase_synthesis_fused(
                (cr, ci), config.input_fft_length, os_f, **kw)
    else:
        from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import (
            polyphase_analysis_fused,
        )

        def forward(xr, xi):
            (cr, ci), nb = polyphase_analysis_fused(
                (xr, xi), filt, n_chan, os_f, time_major=True, keep_padding=True)
            return polyphase_synthesis_fused(
                (cr, ci), config.input_fft_length, os_f, valid_len=nb, **kw)

    def run(signal):
        xr = torch.as_tensor(np.ascontiguousarray(signal.real, np.float32)[None],
                             device=device)
        xi = torch.as_tensor(np.ascontiguousarray(signal.imag, np.float32)[None],
                             device=device)
        rr, ri = forward(xr, xi)
        return (rr.cpu().numpy().astype(np.float64)
                + 1j * ri.cpu().numpy().astype(np.float64)).reshape(-1)

    return run


def subsample(arr, n):
    """Keep at most n points, evenly spread (always keep first/last)."""
    arr = np.asarray(arr)
    if arr.size <= n:
        return arr
    idx = np.unique(np.linspace(0, arr.size - 1, n).round().astype(int))
    return arr[idx]


def sweep(cfg_name: str, npoints: int, out_path: str) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("purity_cuda runs on a CUDA card only "
                         "(torch.cuda.is_available() is False)")
    config = load_config(cfg_name)
    os_f = config.os_factor
    filt = config.load_fir_filter_coeff()
    block_size = os_f.normalize(config.input_fft_length) * config.channels
    output_overlap = os_f.normalize(config.input_overlap) * config.channels
    nblocks = config.blocks
    n_samples = block_size * nblocks
    filt_offset = (filt.size - 1) // 2 + output_overlap
    padded = config.analysis_function == "polyphase_analysis_padded"
    shift = geometry.total_sample_shift(
        config.channels, os_f, config.fir_filter_taps, config.input_overlap,
        padded=padded,
    )
    perf = DomainPerformance(guard=2)
    run = fused_pipeline(config, filt)

    report = {
        "config": cfg_name,
        "backend": "cuda",
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": card_name(),
        "kernel_path": (
            "analysis_padded_fused+chan_dft_fused+synthesis_fused+ifft_big" if padded
            else "analysis_fused+synthesis_fused+ifft_fused"
        ),
        "n_samples": int(n_samples),
        "requirement_dB": -60.0,
    }

    # temporal: impulse at inversion block boundaries, boundaries +-
    # output_overlap, block strides, and a uniform sweep
    offsets = subsample(
        time_domain_offsets(
            npoints, block_size, nblocks, config.input_overlap,
            output_overlap, filt_offset, n_samples,
        ),
        2 * npoints,
    )
    temporal = []
    t0 = time.time()
    for off in offsets:
        sig = time_domain_impulse(
            n_samples, [int(off)], [1], dtype=np.complex64
        )
        inv = run(sig)
        ichop, vchop = chop(config, sig, inv, {})
        if vchop.size == 0:
            continue
        in_window = 0 <= off - shift < vchop.size
        r = perf.temporal_performance(vchop) if in_window else {}
        r.update(perf.temporal_difference(ichop, vchop))
        r["offset"] = int(off)
        r["in_window"] = bool(in_window)
        temporal.append(r)
        print(f"temporal offset={off}: {r}", flush=True)
    report["temporal"] = temporal
    report["temporal_seconds"] = round(time.time() - t0, 1)

    # spectral: tones at exact analysis bins stepping through the band
    freqs = subsample(
        freq_domain_offsets(npoints, block_size, nblocks), npoints
    )
    spectral = []
    t0 = time.time()
    for fq in freqs:
        sig = complex_sinusoid(
            n_samples, [int(fq)], [np.pi / 4], dtype=np.complex64
        )
        inv = run(sig)
        ichop, vchop = chop(config, sig, inv, {})
        if vchop.size == 0:
            continue
        nfft = (vchop.size // block_size) * block_size
        r = perf.spectral_performance(vchop, nfft)
        r.update(perf.temporal_difference(ichop, vchop))
        r["frequency"] = int(fq)
        spectral.append(r)
        print(f"spectral freq={fq}: {r}", flush=True)
    report["spectral"] = spectral
    report["spectral_seconds"] = round(time.time() - t0, 1)

    worst = max(
        (r["max_spurious"] for rs in (temporal, spectral) for r in rs
         if "max_spurious" in r and r.get("in_window", True)),
        default=float("-inf"),
    )
    report["worst_in_window_max_spurious_dB"] = worst
    report["pass"] = bool(worst <= -60.0)

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, cls=NumpyEncoder, indent=2)
    print(f"worst in-window max_spurious: {worst:.1f} dB "
          f"({'PASS' if report['pass'] else 'FAIL'}) -> {out_path} "
          f"({report['nvidia_smi']})", flush=True)
    return 0 if report["pass"] else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", dest="cfg", default="low",
                   choices=["low", "mid"])
    p.add_argument("-n", "--npoints", type=int, default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    npoints = a.npoints or (16 if a.cfg == "low" else 6)
    out = a.out or os.path.join(
        products_dir, f"report.purity.cuda.{a.cfg}.json"
    )
    return sweep(a.cfg, npoints, out)


if __name__ == "__main__":
    raise SystemExit(main())
