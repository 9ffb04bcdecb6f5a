"""Entry points of the port.

* :func:`low_round_trip` / :func:`entry`: the SKA-Low round trip at the
  geometry and input size of the JAX package's ``__graft_entry__.entry``:
  256 channels, OS 4/3, 3073-tap prototype filter (12 taps per channel),
  inversion L=256 / overlap 48 with tukey taper and deripple; 2 pol x 2^18
  samples of seeded noise.
* :func:`mid_round_trip`: the SKA-Mid round trip of
  ``config/test.config.json`` "mid" (bench.py ``bench_mid``): 4096
  channels, OS 8/7, the 100353-tap two-stage filter in the zero-padded
  analysis, inversion L=512 / overlap 128 with tukey taper and deripple.
* :func:`dryrun_multichip`: the sharded pipelines on ``world`` ranks, the
  twin of ``__graft_entry__.dryrun_multichip``: each case checked against
  the input tone or the one-shot models.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, ContextManager, Dict, Optional

import numpy as np
import torch

from ska_pst_dsp_tpu_torch.design import fir
from ska_pst_dsp_tpu_torch.utils.config import load_config
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from .models.round_trip import PaddedPFBRoundTrip, PFBRoundTrip

N_CHAN, TAPS_PER_CHAN, L, OVERLAP = 256, 12, 256, 48
OS_FACTOR = Rational(4, 3)


def low_round_trip(device="cuda") -> PFBRoundTrip:
    """The SKA-Low round-trip module with its state on ``device``."""
    filt = fir.design_pfb_fir_filter(N_CHAN, OS_FACTOR, TAPS_PER_CHAN)
    return PFBRoundTrip.from_filter(filt, N_CHAN, OS_FACTOR, L, OVERLAP,
                                    device=device)


def mid_round_trip(device="cuda") -> PaddedPFBRoundTrip:
    """The SKA-Mid round-trip module with its state on ``device``; the
    filter is designed and cached under ``config/`` on first use."""
    cfg = load_config("mid")
    return PaddedPFBRoundTrip.from_filter(
        cfg.load_fir_filter_coeff(), cfg.channels, cfg.os_factor,
        cfg.input_fft_length, cfg.input_overlap, device=device,
        temporal_taper=cfg.temporal_taper,
    )


def entry(device="cuda", n_dat: int = 2**18, seed: int = 0):
    """Return (fn, example_args): fn maps (re, im) float32 input streams
    (n_pol, n_dat) to the (re, im) inverted output (n_pol, 1, n_out), on
    ``device``."""
    model = low_round_trip(device)

    def forward(xr, xi):
        x = torch.complex(
            torch.as_tensor(xr, device=device), torch.as_tensor(xi, device=device)
        )
        out = model(x)
        return out.real, out.imag

    rng = np.random.default_rng(seed)
    xr = rng.standard_normal((2, n_dat)).astype(np.float32)
    xi = rng.standard_normal((2, n_dat)).astype(np.float32)
    return forward, (xr, xi)


#: the sharded cases' gates (__graft_entry__.py:56, :165-166): the mean
#: error of the reconstructed tone, and the two-stage chains' relative error
#: against the one-shot models
TONE_TOL, TWO_STAGE_TOL = 1e-3, 1e-4


def _tone(n_dat: int) -> np.ndarray:
    """(1, n_dat) complex64 tone at 80.5/1024 cycles a sample."""
    ang = 2 * np.pi * ((80.5 / 1024) * np.arange(n_dat) % 1.0)
    return (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64)[None, :]


def _tone_error(out: torch.Tensor, x: np.ndarray, shift: int) -> float:
    """Mean |out - x delayed by shift| over the overlap (the JAX entry's
    ``_check_tone_reconstruction``)."""
    o = out[0, 0].numpy()
    nn = min(o.size, x.shape[-1] - shift)
    return float(np.abs(o[:nn] - x[0, shift:shift + nn]).mean())


def _rel_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    n = min(got.shape[-1], ref.shape[-1])
    if got.shape[:-1] != ref.shape[:-1] or n == 0:
        raise AssertionError(f"sharded {tuple(got.shape)} vs one-shot {tuple(ref.shape)}")
    ref = ref[..., :n]
    return float((got[..., :n] - ref).abs().max() / ref.abs().max())


def dryrun_multichip(world: int, *, device="cuda",
                     guard: Optional[Callable[[], ContextManager]] = None) -> Dict[str, dict]:
    """Run the sharded pipelines on ``world`` ranks (one process each,
    :func:`.parallel.distributed.spawn`) at the JAX dryrun's geometries and
    stream sizes, and check each case numerically:

    * the SKA-Low round trip (256 channels, 3073 taps, L=256 / overlap 48)
      time-sharded, and on a ('chan', 'time') mesh with dc = 4 where 4
      divides ``world``, else dc = 2 (even worlds): the reconstructed tone
      within 1e-3 mean error;
    * low x low critical with combine 16, and sps -> lowpsi (channels):
      within 1e-4 relative error of the one-shot two-stage models;
    * the SKA-Mid chain (4096 channels, OS 8/7, L=512 / overlap 128)
      time-sharded and (even worlds) on a 2 x world/2 mesh at 28673 taps,
      and time-sharded at the production 100353 taps: the tone within 1e-3.

    The ranks run NCCL where each has a card, else gloo
    (:func:`.parallel.distributed.default_backend`); ``guard`` is entered
    around each case inside every rank (to make the plain versions raise,
    say). Returns {case: {"error", "gate", "results"
    (each rank's :func:`.parallel.distributed.run_calls` entry but its
    output)}}; raises AssertionError for a case past its gate."""
    from .models.two_stage import TwoStageFilterBank, TwoStageInverseFilterBank
    from .parallel import corner_turn, sharded, two_stage_sharded
    from .parallel.distributed import Call, Sharded, assemble, run_calls, spawn
    from .utils import geometry

    filt = fir.design_pfb_fir_filter(N_CHAN, OS_FACTOR, TAPS_PER_CHAN)
    step = geometry.analysis_step(N_CHAN, OS_FACTOR)
    x = _tone(world * step * OS_FACTOR.nu * 260)
    low = (filt, N_CHAN, OS_FACTOR, L, OVERLAP)
    rng = np.random.default_rng(21)
    n = (10_200_000 // (world * 768) + 1) * (world * 768)
    x_ll = (rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))).astype(np.complex64)
    n = (1_500_000 // (world * 216 * 32) + 1) * (world * 216 * 32)
    x_sps = (rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))).astype(np.complex64)
    mid_os = Rational(8, 7)
    mid_taps = 8 * 3584 + 1
    h = np.sinc((np.arange(mid_taps) - (mid_taps - 1) / 2) / 4096) * np.hamming(mid_taps)
    mid_filt = (h / h.sum()).astype(np.float64)
    mid_geom = geometry.SynthesisGeometry(4096, 512, 128, mid_os)
    x_mid = _tone(world * 3584 * mid_geom.input_keep)
    mid = (4096, mid_os, 512, 128)
    prod_filt = fir.design_pfb_fir_filter_two_stage(4096, mid_os, 28)
    low_cfg, sps, lowpsi = load_config("low"), load_config("sps"), load_config("lowpsi")

    with tempfile.TemporaryDirectory(prefix="ska_pst_dryrun_") as tmp:
        def on_disk(name, a):
            path = os.path.join(tmp, name + ".npy")
            np.save(path, a)
            return Sharded(path)

        xs, lls, spss, mids = (on_disk(k, a) for k, a in (
            ("low", x), ("low_low", x_ll), ("sps", x_sps), ("mid", x_mid)))
        cases = {"low-1d": (Call(sharded.sharded_round_trip, (xs, *low)), "time")}
        if world % 2 == 0:
            dc = 4 if world % 4 == 0 else 2
            cases[f"low-2d-dc{dc}"] = (Call(corner_turn.sharded_round_trip_2d, (xs, *low),
                                            mesh_2d=(dc, world // dc)), "time_chan")
        cases["low-low-combine16"] = (Call(two_stage_sharded.sharded_two_stage_round_trip,
                                           (lls, low_cfg, low_cfg),
                                           dict(critical=True, combine=16)), "time")
        cases["sps-lowpsi"] = (Call(two_stage_sharded.sharded_two_stage_round_trip,
                                    (spss, sps, lowpsi), dict(critical=True, invert=False)),
                               "time")
        cases["mid-1d"] = (Call(sharded.sharded_round_trip_padded, (mids, mid_filt, *mid)),
                           "time")
        if world % 2 == 0:
            cases["mid-2d"] = (Call(corner_turn.sharded_round_trip_2d_padded,
                                    (mids, mid_filt, *mid), mesh_2d=(2, world // 2)),
                               "time_chan")
        cases["mid-prod"] = (Call(sharded.sharded_round_trip_padded, (mids, prod_filt, *mid)),
                             "time")
        ranks = spawn(run_calls, world, device=device, timeout=1200.0,
                      args=([c for c, _ in cases.values()], guard))

    report = {}
    low_shift = geometry.total_sample_shift(N_CHAN, OS_FACTOR, filt.size, OVERLAP)
    for i, (name, (call, layout)) in enumerate(cases.items()):
        dc = call.mesh_2d[0] if call.mesh_2d else 1
        out = assemble([r[i]["out"] for r in ranks], layout, dc)
        if name.startswith("low-low"):
            fb = TwoStageFilterBank(low_cfg, low_cfg, critical=True, device=device)
            _, chan = fb.execute(fb.init_state(), x_ll[:, None, :])
            inv = TwoStageInverseFilterBank(low_cfg, low_cfg, combine=16,
                                            nch2=OS_FACTOR.normalize(N_CHAN), device=device)
            _, ref = inv.execute(inv.init_state(), chan)
            err, gate = _rel_error(out, ref.cpu()), TWO_STAGE_TOL
        elif name == "sps-lowpsi":
            fb = TwoStageFilterBank(sps, lowpsi, critical=True, device=device)
            _, ref = fb.execute(fb.init_state(), x_sps[:, None, :])
            err, gate = _rel_error(out, ref.cpu()), TWO_STAGE_TOL
        elif name.startswith("mid"):
            err, gate = _tone_error(out, x_mid, mid_geom.output_overlap - 1), TONE_TOL
        else:
            err, gate = _tone_error(out, x, low_shift), TONE_TOL
        if not out.shape[-1] or not err < gate:
            raise AssertionError(f"dryrun {name} at world {world}: error {err:.3g} "
                                 f"(gate {gate}), output {tuple(out.shape)}")
        report[name] = {"error": err, "gate": gate,
                        "results": [{k: v for k, v in r[i].items() if k != "out"}
                                    for r in ranks]}
    return report
