"""Benchmark of the port: the SKA-Low and SKA-Mid round trips (analysis +
Golden inversion) on one CUDA card through the seven kernels, with a
roofline of the card's own peaks. The counterpart of the repository's
``bench.py`` (the JAX package's benchmark), at its sizes and in its
one-line JSON schema:

    python -m ska_pst_dsp_tpu_torch.bench      # on the card

prints ONE JSON line

  {"metric": "low_roundtrip_throughput", "value": N, "unit": "Msamples/s/chip",
   "vs_baseline": N, "fft_precision": "fp32", "roofline": {...},
   "ms_per_call": {...}, "max_err_vs_oracle": x, "launches_per_call": {...},
   "mid": {...}, "baseline": {...}, "device": {"name": ..., "power_limit_w": ...}}

* low (:data:`CONFIGS`): 256 channels, OS 4/3, 3073 taps, L=256 / overlap
  48, 2 pol x 2^23 samples through :class:`.models.PFBRoundTrip`
  (analysis_fused, then inversion_fused: the frontend and the epilogue in one
  kernel); mid: 4096 channels, OS
  8/7, the 100353-tap two-stage filter zero-padded, L=512 / overlap 128, 2
  pol x 4,587,520 samples through :class:`.models.PaddedPFBRoundTrip` (the
  padded fold, the channel DFT, the frontend, the ifft_big pair). The
  input is seeded noise (``default_rng(0)``), copied to the card once.
* Timing (:func:`time_forward`): CUDA events around windows of ``reps``
  forwards back to back, after warm-up; ms per call is a window over
  ``reps``, reported as the median, min and max of 10 windows. Eager
  PyTorch elides no call, so no carry runs between them. Beside it each
  kernel's launch count over the timed calls, per call, and the epilogues
  run composed (no kernel takes their length).
* Error: low against the fp64 numpy oracle on a 2^19-sample prefix, max
  |err| / max |ref| within 3e-6 (tests/test_synthesis.py:37); mid, one
  inversion block, max within 1e-6 and mean within 2e-7 of the scale
  (tests/test_mid_production.py:144-145). A run past them raises.
* vs_baseline: the low samples/s over the numpy oracle's on the same math
  on this host's CPU (:func:`bench_oracle_cpu`, 2 pol x 2^19 complex64).
* Roofline (:func:`roofline`): the FFT-optimal flops per sample (5 N log2
  N per transform, 4 per filter tap) and the essential bytes per sample
  (raw in, fine channels out and back in, raw out) against the card's HBM
  and fp32 (no tensor core) peaks, from :data:`PEAKS` by
  ``torch.cuda.get_device_name``; a card not in the table raises.
  ``bench.py``'s ``flops_per_sample_matmul``, ``sol_mxu_msps``,
  ``tflops_executed`` and ``mxu_util_pct`` count the TPU's Karatsuba
  matmul DFT, which the card never runs: they are left out.

Nothing falls back: on a host without CUDA the default device raises, and
no failure of mid or of the baseline is caught. ``device="cpu"`` (the
tests) runs the same code on the kernels' plain versions, timed with the
host clock, and names the card whose peaks its roofline takes.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ska_pst_dsp_tpu_torch import oracle
from ska_pst_dsp_tpu_torch.design import fir
from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.profiling import clock
from ska_pst_dsp_tpu_torch.utils.rational import Rational
from ska_pst_dsp_tpu_torch.utils.windows import tukey_window

from .models.round_trip import PaddedPFBRoundTrip, PFBRoundTrip
from .ops.kernels import wrappers
from .ops.kernels.synthesis_fused import fused_inversion

CONFIGS = {
    "low": dict(n_chan=256, taps_per_chan=12, L=256, ov=48, nu=4, de=3),
    "mid": dict(n_chan=4096, taps=100353, L=512, ov=128, nu=8, de=7),
}
#: (HBM bytes/s, fp32 flop/s outside the tensor cores) of each card, by
#: ``torch.cuda.get_device_name``: NVIDIA's data sheets, at the full power
#: limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),  # SXM5
    "NVIDIA H100 PCIe": (2.0e12, 51e12),
    "NVIDIA H100 NVL": (3.9e12, 60e12),
}
#: the kernels each round trip launches once a call (none composed)
KERNELS = {
    "low": ("analysis_fused", "inversion_fused"),
    "mid": ("analysis_padded_fused", "chan_dft_fused", "synthesis_fused",
            "ifft_big_inner", "ifft_big_outer"),
}
WINDOWS = 10
SEED = 0
ORACLE_PREFIX = 2 ** 19
ORACLE_TOL = 3e-6
MID_ORACLE_MAX, MID_ORACLE_MEAN = 1e-6, 2e-7
#: the seed of the mid oracle block (tests/test_mid_production.py:118)
MID_ORACLE_SEED = 7


def peaks(device_name: str) -> Tuple[float, float]:
    """(HBM bytes/s, fp32 flop/s) of the card named ``device_name``."""
    try:
        return PEAKS[device_name]
    except KeyError:
        raise ValueError(f"no peaks for {device_name!r}: the table holds "
                         f"{sorted(PEAKS)}") from None


def _fft_flops(n):
    return 5.0 * n * math.log2(n)


def roofline(name: str, msps: float, device_name: str,
             config: Optional[dict] = None) -> dict:
    """Roofline of ``CONFIGS[name]`` (or ``config``) at an achieved
    Msamples/s against the peaks of the card ``device_name``. A share of
    the speed of light above 100 % is a fault of the model or the timing,
    and raises."""
    c = CONFIGS[name] if config is None else config
    os_f = Rational(c["nu"], c["de"])
    n_chan, L, ov = c["n_chan"], c["L"], c["ov"]
    taps = c.get("taps", n_chan * c.get("taps_per_chan", 12) + 1)
    step = geometry.analysis_step(n_chan, os_f)
    fl = geometry.padded_filter_length(taps, n_chan)
    geom = geometry.SynthesisGeometry(n_chan, L, ov, os_f)

    # FFT-optimal flops per raw sample (fold: 4 flops/tap complex*real MAC)
    ana = (4.0 * fl + _fft_flops(n_chan)) / step
    per_block = (
        n_chan * _fft_flops(L)
        + 6.0 * n_chan * geom.fn_width
        + _fft_flops(geom.output_fft_length)
    )
    f_opt = ana + per_block / geom.output_keep

    # memory floor: raw in + fine out + fine in + raw out, complex64
    os = c["nu"] / c["de"]
    bytes_per_sample = 8 + 2 * 8 * os + 8
    hbm, fp32 = peaks(device_name)
    sol_mem = hbm / bytes_per_sample
    sol_fp32 = fp32 / f_opt
    sol = min(sol_mem, sol_fp32)
    achieved = msps * 1e6
    pct = 100.0 * achieved / sol
    if not 0.0 < pct <= 100.0:
        raise ValueError(f"{name}: {msps} Msamples/s is {pct:.2f} % of the "
                         f"{sol / 1e6:.1f} Msamples/s speed of light on {device_name}")
    return {
        "card": device_name,
        "flops_per_sample_fft_optimal": round(f_opt, 1),
        "bytes_per_sample": bytes_per_sample,
        "sol_msps": round(sol / 1e6, 1),
        "sol_mem_msps": round(sol_mem / 1e6, 1),
        "sol_fp32_msps": round(sol_fp32 / 1e6, 1),
        "pct_sol": round(pct, 2),
        "tflops_effective": round(achieved * f_opt / 1e12, 3),
    }


def design_filter(c: dict) -> np.ndarray:
    """The prototype filter of a config, designed as ``bench.py`` designs
    it: low's single-stage least squares at ``taps_per_chan``; mid's
    two-stage design at (taps - 1) / step oversampled taps per channel (28
    at mid)."""
    os_f = Rational(c["nu"], c["de"])
    if "taps" not in c:
        return fir.design_pfb_fir_filter(c["n_chan"], os_f, c["taps_per_chan"])
    per_chan, rem = divmod(c["taps"] - 1, geometry.analysis_step(c["n_chan"], os_f))
    filt = fir.design_pfb_fir_filter_two_stage(c["n_chan"], os_f, per_chan)
    if rem or filt.size != c["taps"]:
        raise ValueError(f"{c['taps']} taps is no two-stage design's length")
    return filt


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the bench runs on the card unless "
                           "it is given device='cpu'")
    return device


def _module(cls, filt: np.ndarray, c: dict, device: torch.device):
    return cls.from_filter(filt, c["n_chan"], Rational(c["nu"], c["de"]), c["L"], c["ov"],
                           device=device)


def _noise(n_dat: int, device, seed: int = SEED) -> torch.Tensor:
    """(2, n_dat) complex64 on ``device``: ``bench.py``'s input, real parts
    then imaginary parts from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    xr = rng.standard_normal((2, n_dat)).astype(np.float32)
    xi = rng.standard_normal((2, n_dat)).astype(np.float32)
    return torch.complex(torch.as_tensor(xr), torch.as_tensor(xi)).to(device)


def time_forward(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                 reps: int) -> dict:
    """Time ``fn(x)``: two warm-up calls, then :data:`WINDOWS` windows of
    ``reps`` calls back to back, each window on :func:`.profiling.clock`.
    Returns samples/s at the median, ms per call (median, min, max over
    the windows), and each kernel's launches and the composed epilogues
    over the timed calls, per call."""
    sync = torch.cuda.synchronize if x.device.type == "cuda" else (lambda: None)
    for _ in range(2):
        fn(x)
    sync()
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    fused_inversion.composed_epilogues = 0
    per_call = []
    for _ in range(WINDOWS):
        stop = clock(x.device)
        for _ in range(reps):
            fn(x)
        per_call.append(stop() / reps)
    calls = reps * WINDOWS
    launches = {k: w.launches / calls for k, w in ws.items()}
    launches["composed_epilogues"] = fused_inversion.composed_epilogues / calls
    ms = statistics.median(per_call)
    return {"samples_per_s": x.numel() / (ms * 1e-3),
            "ms_per_call": {"median": ms, "min": min(per_call), "max": max(per_call)},
            "launches_per_call": launches, "n_pol": x.shape[0], "n_dat": x.shape[1],
            "reps": reps, "windows": WINDOWS}


def check_launches(name: str, launches: Dict[str, float]) -> None:
    """On the card each of the round trip's kernels launches once a call,
    no other kernel launches and no epilogue runs composed."""
    want = {k: float(k in KERNELS[name]) for k in launches}
    if launches != want:
        raise AssertionError(f"{name}: launches per call {launches}, expected {want}")


def oracle_round_trip(x: np.ndarray, filt: np.ndarray, n_chan: int, os_factor, L: int,
                      ov: int, *, padded: bool = False) -> np.ndarray:
    """The numpy oracle's round trip of (n_pol, 1, n_dat) ``x``, in x's
    precision: the analysis (zero-padded where ``padded``) then the Golden
    inversion with deripple and a tukey taper; (n_pol, 1, n_out)."""
    analysis = oracle.polyphase_analysis_padded if padded else oracle.polyphase_analysis
    chan = analysis(x, filt, n_chan, os_factor)
    return oracle.polyphase_synthesis(
        chan, L, os_factor, input_overlap=ov, deripple_coeff=filt,
        temporal_taper=tukey_window(L, ov).astype(np.float64),
    )


def _module_args(model) -> tuple:
    g = model.geom
    return model.n_chan, model.os_factor, g.input_fft_length, g.input_overlap


def low_oracle_error(model: PFBRoundTrip, filt: np.ndarray, x: torch.Tensor,
                     prefix: int = ORACLE_PREFIX) -> float:
    """max |err| / max |ref| of the module's output for the first
    ``prefix`` samples of ``x`` against the fp64 oracle on them."""
    xp = x[:, :prefix]
    got = model(xp).cpu().numpy().astype(np.complex128)
    ref = oracle_round_trip(xp.cpu().numpy()[:, None, :].astype(np.complex128), filt,
                            *_module_args(model))
    if got.shape != ref.shape:
        raise AssertionError(f"oracle shapes {got.shape} vs {ref.shape}")
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def mid_oracle_error(model: PaddedPFBRoundTrip, filt: np.ndarray,
                     seed: int = MID_ORACLE_SEED) -> Tuple[float, float]:
    """(max, mean) of |err| / max |ref| of one inversion block of seeded
    noise through the module against the fp64 oracle
    (tests/test_mid_production.py:114-145)."""
    g = model.geom
    n = (2 * g.input_overlap + g.input_keep) * model.step
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)[None, None]
    got = model(torch.as_tensor(x[:, 0], device=model.t_taper.device)).cpu().numpy()[0, 0]
    ref = oracle_round_trip(x.astype(np.complex128), filt, *_module_args(model),
                            padded=True)[0, 0]
    if got.shape != ref.shape:
        raise AssertionError(f"mid oracle shapes {got.shape} vs {ref.shape}")
    d = np.abs(got.astype(np.complex128) - ref) / np.abs(ref).max()
    return float(d.max()), float(d.mean())


def bench_low(n_dat: int = 2 ** 23, reps: int = 50, device="cuda") -> dict:
    """The SKA-Low round trip on ``device``: :func:`time_forward` of the
    module on 2 pol x ``n_dat`` samples, and ``max_err_vs_oracle`` on a
    2^19-sample prefix (the whole stream where shorter)."""
    dev = _device(device)
    c = CONFIGS["low"]
    filt = design_filter(c)
    model = _module(PFBRoundTrip, filt, c, dev)
    x = _noise(n_dat, dev)
    out = time_forward(model, x, reps)
    out["max_err_vs_oracle"] = low_oracle_error(model, filt, x, min(ORACLE_PREFIX, n_dat))
    return out


def bench_mid(reps: int = 10, device="cuda", config: Optional[dict] = None) -> dict:
    """The SKA-Mid round trip (``CONFIGS["mid"]``, or a padded ``config``
    of the same keys) on ``device``: :func:`time_forward` of the module on
    2 pol x (2 ov + 4 input_keep) step samples (4,587,520 at mid), and
    ``max_err_vs_oracle`` {max, mean} of one inversion block."""
    dev = _device(device)
    c = CONFIGS["mid"] if config is None else config
    filt = design_filter(c)
    model = _module(PaddedPFBRoundTrip, filt, c, dev)
    g = model.geom
    x = _noise((2 * g.input_overlap + 4 * g.input_keep) * model.step, dev)
    out = time_forward(model, x, reps)
    err_max, err_mean = mid_oracle_error(model, filt)
    out["max_err_vs_oracle"] = {"max": err_max, "mean": err_mean}
    return out


def baseline_input(n_dat: int) -> np.ndarray:
    """(2, 1, n_dat) complex64: the baseline's seeded input."""
    rng = np.random.default_rng(SEED)
    return (rng.standard_normal((2, 1, n_dat))
            + 1j * rng.standard_normal((2, 1, n_dat))).astype(np.complex64)


def bench_oracle_cpu(n_dat: int = 2 ** 19) -> float:
    """Samples/s of the single-threaded numpy oracle running the low round
    trip's math on this host: the proxy for the reference
    implementation's per-core throughput."""
    c = CONFIGS["low"]
    filt = design_filter(c)
    x = baseline_input(n_dat)
    t0 = time.perf_counter()
    oracle_round_trip(x, filt, c["n_chan"], Rational(c["nu"], c["de"]), c["L"], c["ov"])
    return x.shape[0] * n_dat / (time.perf_counter() - t0)


def card_info(index: int = 0) -> dict:
    """{name, power_limit_w} of card ``index`` from ``nvidia-smi``; raises
    where it cannot be read."""
    line = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0])}


def main(device="cuda", *, n_dat: int = 2 ** 23, reps: Tuple[int, int] = (50, 10),
         mid_config: Optional[dict] = None, baseline_n_dat: int = 2 ** 19,
         card: Optional[str] = None) -> dict:
    """Run low, mid and the baseline; print ONE JSON line and return it as
    a dict. On the card the roofline takes that card's peaks and the
    device is read from ``nvidia-smi``; a CPU run (``device="cpu"``, at
    the sizes given) names the ``card`` of its roofline. ``reps`` is
    (low, mid) calls per window."""
    dev = _device(device)
    if dev.type == "cuda":
        card = torch.cuda.get_device_name(dev)
        info = card_info(dev.index or 0)
    elif card is None:
        raise ValueError("a CPU run names the card whose peaks its roofline takes")
    else:
        info = {"name": "cpu", "power_limit_w": None}
    low = bench_low(n_dat, reps[0], dev)
    mid = bench_mid(reps[1], dev, mid_config)
    baseline = bench_oracle_cpu(baseline_n_dat)
    if dev.type == "cuda":
        check_launches("low", low["launches_per_call"])
        check_launches("mid", mid["launches_per_call"])
    err = mid["max_err_vs_oracle"]
    if not (low["max_err_vs_oracle"] <= ORACLE_TOL and err["max"] <= MID_ORACLE_MAX
            and err["mean"] <= MID_ORACLE_MEAN):
        raise AssertionError(f"against the fp64 oracle: low {low['max_err_vs_oracle']:.3g} "
                             f"(tol {ORACLE_TOL}), mid max {err['max']:.3g} (tol "
                             f"{MID_ORACLE_MAX}), mean {err['mean']:.3g} (tol {MID_ORACLE_MEAN})")

    def leg(name, r, config=None):
        msps = r["samples_per_s"] / 1e6
        return {"value": round(msps, 3), "unit": "Msamples/s/chip",
                "roofline": roofline(name, msps, card, config),
                **{k: r[k] for k in ("ms_per_call", "max_err_vs_oracle", "launches_per_call",
                                     "n_pol", "n_dat", "reps", "windows")}}

    out = {"metric": "low_roundtrip_throughput", **leg("low", low),
           "vs_baseline": round(low["samples_per_s"] / baseline, 2),
           "fft_precision": "fp32",
           "mid": leg("mid", mid, mid_config),
           "baseline": {"msamples_per_s": baseline / 1e6, "n_pol": 2, "n_dat": baseline_n_dat},
           "device": info}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
