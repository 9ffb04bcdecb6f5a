#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the SKA-Low PFB round trip on one GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases (one line each; any failure raises and the exit code is non-zero):

1. card: requires CUDA; prints ``nvidia-smi`` name and power limit; turns
   TF32 off for matmul and cuDNN.
2. build: compiles ska_pst_dsp_tpu_torch/csrc/*.cu with nvcc (seconds).
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes: max |err| / scale within 8e-6 (analysis) and
   1.2e-5 (frontend, epilogue with and without ``elem``), the tolerances of
   tests/test_pallas.py; each kernel's time beside its plain version's.
4. slice: 2 pol x 2^23 samples (bench.py's size) through
   ``PFBRoundTrip`` on the kernels: every launch counter rises, the output is
   finite and matches the plain chain on the card (1.2e-5 * scale) and, on a
   2^19-sample prefix, the fp64 numpy oracle (3e-6 * scale, the tolerance of
   tests/test_synthesis.py:37).
5. purity: an integer-bin tone and an impulse through the kernels, scored
   with verify.util.DomainPerformance; max spurious <= -60 dB.
6. dada: fine channels -> io.dada save/load -> fused inversion, equal to the
   direct inversion.
7. no fallback: a mid geometry (1.8M-point epilogue) on CUDA raises
   NotImplementedError.
8. timing: the kernel chain and the plain chain (CUDA events, warm-up,
   median of repetitions), in Msamples/s with the card's name and limit.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_DAT = 2 ** 23
PREFIX = 2 ** 19
SEED = 0
ANALYSIS_TOL = 8e-6
SYNTHESIS_TOL = 1.2e-5
ORACLE_TOL = 3e-6
PURITY_DB = -60.0
REPS = 10


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rel_err(got, ref):
    """(max |got - ref|, that over max |ref|), reduced on the card."""
    err = float((got - ref).abs().max())
    return err, err / float(ref.abs().max())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, reps: int = REPS) -> float:
    """Median over ``reps`` of one call, timed with CUDA events after two
    warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32)
            + 1j * rng.standard_normal(shape, dtype=np.float32)).astype(np.complex64)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ska_pst_dsp_tpu import oracle
    from ska_pst_dsp_tpu.io import dada
    from ska_pst_dsp_tpu.utils import geometry, windows
    from ska_pst_dsp_tpu.utils.config import load_config
    from ska_pst_dsp_tpu.verify.util import DomainPerformance
    from ska_pst_dsp_tpu_torch.entry import L, N_CHAN, OS_FACTOR, OVERLAP, low_round_trip
    from ska_pst_dsp_tpu_torch.ops import synthesis as plain_synth
    from ska_pst_dsp_tpu_torch.ops.analysis import analysis_core
    from ska_pst_dsp_tpu_torch.ops.kernels import _build
    from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import (
        analysis_fused, polyphase_analysis_fused,
    )
    from ska_pst_dsp_tpu_torch.ops.kernels.ifft_fused import fused_big_ifft, plan_ifft
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import (
        polyphase_synthesis_fused, synthesis_fused,
    )

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log("card", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build
    prebuilt = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    log("build", f"{_build.library_path().name}: "
        + ("found built" if prebuilt else "nvcc build")
        + f", {time.perf_counter() - t0:.1f} s to build and load")

    # 3. kernels against their plain versions at the main path's shapes
    model = low_round_trip(dev)
    g = model.geom
    x = torch.as_tensor(noise((2, N_DAT), SEED), device=dev)
    kernels = []

    def compare(name, err, tol, ms, plain_ms):
        check(err[1] <= tol, f"{name}: max|err|/scale {err[1]:.3g} > {tol}")
        log("kernels", f"{name}: max|err| {err[0]:.3g}, /scale {err[1]:.3g} "
            f"(tol {tol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    def record(name, replaces, err, tol, ms, plain_ms):
        compare(name, err, tol, ms, plain_ms)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ska_pst_dsp_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "max_abs_err": err[0], "max_rel_err": err[1],
            "tol": tol, "ms": ms, "plain_ms": plain_ms,
        })

    def a_kernel():
        return analysis_fused(x, model.f2d, model.ramp, model.step)

    def a_plain():
        return analysis_core(x, model.f2d, model.ramp, model.step)

    chan = a_plain()
    record("analysis_fused",
           "ska_pst_dsp_tpu/ops/pallas/analysis_fused.py:307",
           rel_err(a_kernel(), chan), ANALYSIS_TOL,
           time_ms(torch, a_kernel), time_ms(torch, a_plain))

    nb = g.n_blocks(chan.shape[1])
    kpos = (L // 2 + g.discard) % L
    fargs = (chan, model.t_taper, model.dr, model.perm, L, g.input_keep, kpos, nb)
    fn = plain_synth.frontend(*fargs)
    record("synthesis_fused",
           "ska_pst_dsp_tpu/ops/pallas/synthesis_fused.py:244",
           rel_err(synthesis_fused(*fargs), fn), SYNTHESIS_TOL,
           time_ms(torch, lambda: synthesis_fused(*fargs)),
           time_ms(torch, lambda: plain_synth.frontend(*fargs)))
    del chan

    n, lo, roll = g.output_fft_length, g.output_overlap, g.fn_width // 2
    gain = OS_FACTOR.de / OS_FACTOR.nu
    plan = plan_ifft(n, lo)
    check(plan == (128, 384), f"plan_ifft({n}, {lo}) = {plan}")
    flat = fn.reshape(2, nb, n)
    elem = torch.as_tensor(np.roll(windows.build("tukey", n, OVERLAP), roll)
                           .astype(np.complex64), device=dev)
    results = []
    for e in (elem, None):  # the main path's epilogue has no elem: last
        def e_kernel(e=e):
            return fused_big_ifft(flat, e, shape_key=(n, *plan, lo, roll, gain), n_valid=nb)

        def e_plain(e=e):
            return plain_synth.epilogue(flat, e, lo, roll, gain, nb)

        results.append((rel_err(e_kernel(), e_plain()), time_ms(torch, e_kernel),
                        time_ms(torch, e_plain)))
    compare("ifft_fused with elem", *results[0][:1], SYNTHESIS_TOL, *results[0][1:])
    worst = max((r[0] for r in results), key=lambda err: err[1])
    record("ifft_fused", "ska_pst_dsp_tpu/ops/pallas/ifft_fused.py:268",
           worst, SYNTHESIS_TOL, *results[1][1:])
    del fn, flat

    # 4. the slice at full size through the module, then the oracle prefix
    wrappers = {"analysis_fused": analysis_fused, "synthesis_fused": synthesis_fused,
                "ifft_fused": fused_big_ifft}
    for w in wrappers.values():
        w.launches = 0
    out = model(x)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log("slice", f"launch counts over one forward of 2 x 2^23: {launches}")
    for k, count in launches.items():
        check(count > 0, f"{k} was not launched by the main path")
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    n_out = g.n_blocks(geometry.analysis_nblocks(N_DAT, 3073, N_CHAN, OS_FACTOR)) * g.output_keep
    check(tuple(out.shape) == (2, 1, n_out), f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(torch.view_as_real(out)).all()), "non-finite output")
    err = rel_err(out, model.reference(x))
    check(err[1] <= SYNTHESIS_TOL, f"kernel chain vs plain chain {err[1]:.3g}")
    log("slice", f"output {tuple(out.shape)} finite; vs plain chain max|err| "
        f"{err[0]:.3g}, /scale {err[1]:.3g} (tol {SYNTHESIS_TOL})")
    del out

    filt = model_filter()
    xp = x[:, :PREFIX]
    got = model(xp).cpu().numpy().astype(np.complex128)
    ch = oracle.polyphase_analysis(xp.cpu().numpy()[:, None, :].astype(np.complex128),
                                   filt, N_CHAN, OS_FACTOR)
    ref = oracle.polyphase_synthesis(
        ch, L, OS_FACTOR, input_overlap=OVERLAP, deripple_coeff=filt,
        temporal_taper=windows.tukey_window(L, OVERLAP).astype(np.float64),
    )
    check(got.shape == ref.shape, f"oracle shapes {got.shape} vs {ref.shape}")
    oerr = float(np.abs(got - ref).max() / np.abs(ref).max())
    check(oerr <= ORACLE_TOL, f"kernel chain vs fp64 oracle {oerr:.3g}")
    log("slice", f"2^19-sample prefix vs fp64 oracle: max|err|/scale {oerr:.3g} "
        f"(tol {ORACLE_TOL})")

    # 5. purity through the kernels
    cfg = load_config("low")
    block = g.output_fft_length
    ns = block * cfg.blocks
    shift = geometry.total_sample_shift(N_CHAN, OS_FACTOR, filt.size, OVERLAP)
    perf = DomainPerformance(guard=2)
    t = np.arange(ns)
    fq = cfg.blocks * 1001  # a multiple of the block count: an integer bin
    tone = np.exp(1j * (2 * np.pi * ((fq * t) % ns) / ns + np.pi / 4)).astype(np.complex64)
    impulse = np.zeros(ns, np.complex64)
    offset = shift + 40_000
    impulse[offset] = 1.0
    worst = -np.inf
    for name, sig in (("tone", tone), ("impulse", impulse)):
        inv = model(torch.as_tensor(sig[None], device=dev)).cpu().numpy()[0, 0]
        v = inv[: min(inv.size, ns - shift)]
        if name == "tone":
            r = perf.spectral_performance(v, (v.size // block) * block)
        else:
            r = perf.temporal_performance(v)
            check(int(np.argmax(np.abs(v))) == offset - shift, "impulse misaligned")
        worst = max(worst, r["max_spurious"])
        log("purity", f"{name}: max spurious {r['max_spurious']:.2f} dB, total "
            f"{r['total_spurious']:.2f} dB")
    check(worst <= PURITY_DB, f"purity {worst:.2f} dB > {PURITY_DB} dB")
    log("purity", f"worst max spurious {worst:.2f} dB <= {PURITY_DB} dB")

    # 6. fine channels through a DADA file and back
    pair = (xp.real.contiguous(), xp.imag.contiguous())
    kw = dict(input_overlap=OVERLAP, deripple_coeff=filt, temporal_taper="tukey")
    chan_cm = polyphase_analysis_fused(xp, filt, N_CHAN, OS_FACTOR)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chan.dada")
        dada.save(path, chan_cm.cpu().numpy(), cfg.load_header())
        loaded, _ = dada.load(path)
    inv_file = polyphase_synthesis_fused(torch.as_tensor(loaded, device=dev), L,
                                         OS_FACTOR, **kw)
    (cr, ci), nbk = polyphase_analysis_fused(pair, filt, N_CHAN, OS_FACTOR,
                                             time_major=True, keep_padding=True)
    ir, ii = polyphase_synthesis_fused((cr, ci), L, OS_FACTOR, time_major_in=True,
                                       valid_len=nbk, **kw)
    derr = rel_err(inv_file, torch.complex(ir, ii))
    check(derr[1] <= SYNTHESIS_TOL, f"DADA round trip {derr[1]:.3g}")
    log("dada", f"channels {tuple(loaded.shape)} via DADA, inverted: vs direct "
        f"max|err|/scale {derr[1]:.3g}")

    # 7. no hidden fallback for the epilogue that has no kernel yet
    mid = torch.zeros((1, 512, 4096), dtype=torch.complex64, device=dev)
    try:
        polyphase_synthesis_fused(mid, 512, "8/7", input_overlap=128, time_major_in=True)
    except NotImplementedError as e:
        log("fallback", f"mid geometry on CUDA raises NotImplementedError: {e}")
    else:
        raise AssertionError("mid geometry on CUDA did not raise")

    # 8. timing: kernel chain vs plain chain, interleaved
    msps = {}
    for name in ("plain", "kernels", "kernels", "plain"):
        fn_ = model.reference if name == "plain" else model
        ms = time_ms(torch, lambda: fn_(x))
        msps.setdefault(name, []).append((ms, 2 * N_DAT / (ms * 1e3)))
    for name, runs in msps.items():
        log("timing", f"{name} chain, 2 x 2^23 samples: "
            + ", ".join(f"{ms:.3f} ms = {r:.1f} Msamples/s" for ms, r in runs)
            + f" (median of {REPS}, {kind}, {smi})")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


def model_filter():
    from ska_pst_dsp_tpu.design import fir
    from ska_pst_dsp_tpu_torch.entry import N_CHAN, OS_FACTOR, TAPS_PER_CHAN

    return fir.design_pfb_fir_filter(N_CHAN, OS_FACTOR, TAPS_PER_CHAN)


if __name__ == "__main__":
    sys.exit(main())
