"""On-card dedispersion round trip through the port's CUDA kernel chain.

The spectral_filter slot of the Golden inversion (native analog of dspsr's
convolution-during-inversion, reference
python/verify/test_dedispersion.py:54-321) rides the epilogue kernel's
``elem`` factor in ``ska_pst_dsp_tpu_torch``: analysis_fused →
synthesis_fused → the cluster epilogue (ifft_fused) with the chirp as
``elem``, on the card:

  gate:  the fused ``elem`` inversion must match the COMPOSED
         spectral_filter inversion (the plain ``ops.analysis`` /
         ``ops.synthesis`` on torch.fft) on the same card to fp32 class
         (max rel diff < 1e-4) — implementation equivalence of the hook;
  info:  the fused inversion is also compared against whole-stream
         dedispersion of the unfiltered inversion; the per-block chirp
         approximation bounds that near -30 dB (chirp tails beyond the
         overlap-save discard), so it is recorded, not gated (the
         whole-stream commutation gate is verify/test_dedispersion.py's).

Writes products/report.dedispersion.cuda.json with the card's name and
power limit (``nvidia-smi``); exits non-zero on gate failure. It runs on
the card only.

    python tools/dedispersion_cuda.py
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

from ska_pst_dsp_tpu_torch.data_gen.config import products_dir  # noqa: E402
from ska_pst_dsp_tpu_torch.data_gen.util import NumpyEncoder  # noqa: E402
from ska_pst_dsp_tpu_torch.models.signals import SquareWave  # noqa: E402
from ska_pst_dsp_tpu_torch.ops import dedispersion  # noqa: E402
from ska_pst_dsp_tpu_torch.utils import geometry  # noqa: E402
from ska_pst_dsp_tpu_torch.utils.config import load_config  # noqa: E402
from ska_pst_dsp_tpu_torch.verify.util import dB  # noqa: E402


def card_name() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def round_trip(device) -> dict:
    """The low chain with the chirp as ``elem`` and its plain counterpart on
    ``device``: the report's measured fields. On a CPU device both run the
    plain versions (the tests' check of the plumbing)."""
    import torch

    from ska_pst_dsp_tpu_torch.ops import analysis, synthesis
    from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import (
        polyphase_analysis_fused,
    )
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import (
        polyphase_synthesis_fused,
    )

    config = load_config("low")
    # overlap-save validity: the chirp's (one-sided) dispersion delay must
    # fit inside the per-side discard output_overlap = 9216 samples; at
    # 1405 MHz / 40 MHz band the delay is ~4792*dm samples, so dm <= 1.92
    dm, f0, bw = 1.5, 1405.0, 40.0
    filt = config.load_fir_filter_coeff()
    os_f = config.os_factor
    n_chan, L, ov = config.channels, config.input_fft_length, config.input_overlap
    geom = geometry.SynthesisGeometry(n_chan, L, ov, os_f)
    n_bins = geom.fn_width * n_chan * config.blocks * 2

    sw = SquareWave(period=4096, duty_cycle=0.1, on_amp=4.0, off_amp=0.04,
                    seed=11, device=device)
    clean = sw.generate(0, n_bins)[0, 0]
    dispersed = dedispersion.dedisperse(clean[None], dm, f0, bw, inverse=True)[0]
    xr = dispersed.real.contiguous()[None]
    xi = dispersed.imag.contiguous()[None]
    h = dedispersion.chirp_filter(n_chan * geom.fn_width, dm, f0, bw)
    kw = dict(input_overlap=ov, deripple_coeff=filt if config.deripple else None,
              temporal_taper=config.temporal_taper)

    def run(spectral_filter):
        (cr, ci), nb = polyphase_analysis_fused(
            (xr, xi), filt, n_chan, os_f, time_major=True, keep_padding=True)
        rr, ri = polyphase_synthesis_fused(
            (cr, ci), L, os_f, time_major_in=True, valid_len=nb,
            spectral_filter=spectral_filter, **kw)
        return torch.complex(rr, ri).reshape(-1)

    # path B: the kernel chain with the chirp riding the epilogue's elem
    b = run(h)

    # path C: the plain (composed) chain with the same spectral_filter, on
    # the same device — the gate is implementation equivalence of the hook
    chan = analysis.polyphase_analysis((xr, xi), filt, n_chan, os_f)
    cr, ci = synthesis.polyphase_synthesis(chan, L, os_f, spectral_filter=h, **kw)
    c = torch.complex(cr, ci).reshape(-1)

    m = min(b.shape[0], c.shape[0])
    impl_err = float((b[:m] - c[:m]).abs().max() / c[:m].abs().max())

    # informational: commutation against whole-stream dedispersion
    a = dedispersion.dedisperse(run(None)[None], dm, f0, bw)[0].cpu().numpy()
    b = b.cpu().numpy()
    mm = min(a.size, b.size)
    guard = mm // 8
    diff = np.abs(b[guard: mm - guard] - a[guard: mm - guard]) ** 2
    ref = np.abs(a[guard: mm - guard]) ** 2
    return {
        "dm": dm,
        "n_compared": int(m),
        "fused_vs_composed_max_rel": impl_err,
        "blockwise_vs_wholestream_mean_db": float(dB(diff.mean() / ref.mean())),
        "blockwise_vs_wholestream_max_db": float(dB(diff.max() / ref.max())),
    }


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(products_dir,
                                                 "report.dedispersion.cuda.json"))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dedispersion_cuda runs on a CUDA card only "
                         "(torch.cuda.is_available() is False)")
    report = {
        "config": "low",
        "backend": "cuda",
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": card_name(),
        "kernel_path": "analysis_fused+synthesis_fused+ifft_fused(elem)",
        **round_trip(torch.device("cuda", 0)),
    }
    report["pass"] = bool(report["fused_vs_composed_max_rel"] < 1e-4)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(report, f, cls=NumpyEncoder, indent=2)
    print(json.dumps(report), flush=True)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
