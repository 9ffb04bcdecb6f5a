#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the SKA-Low and SKA-Mid PFB round trips
on one GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases (one line each; any failure raises and the exit code is non-zero):

1. card: requires CUDA; prints ``nvidia-smi`` name and power limit; turns
   TF32 off for matmul and cuDNN.
2. build: compiles ska_pst_dsp_tpu_torch/csrc/*.cu with nvcc (seconds);
   prints each kernel's registers and spills from ``ptxas -v``.
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes: max |err| / scale within 8e-6 (analysis) and
   1.2e-5 (frontend, epilogue with and without ``elem``), the tolerances of
   tests/test_pallas.py; each kernel's time beside its plain version's, back
   to back and, from torch.profiler, on the device; the epilogue's resident
   clusters, its ratio to torch.fft.ifft and to a yardstick, the ifft_big
   pair run at the low shape (n2 = 1 * 128, n1 = 384). Then the fused
   inversion (``inversion_fused``: frontend and cluster epilogue in one
   kernel, which the low main path runs) against its plain version (the
   frontend then the epilogue; 1.2e-5 * scale, with and without ``elem``)
   at 2 x 272 blocks and at a stream block's batch of 2 x 2 blocks of a
   channel-major view, each beside the two kernels it replaces; and its
   instance at a LowCBF PST slab's geometry (216 monotonic channels, 41472
   points) at the SKA-Low PST cascade's shapes, 512 slabs of 9 and of 18
   blocks of a channel-major buffer read through its transposed view,
   against its plain version (with and without ``elem``) and beside the
   route it replaces there, the frontend kernel then the composed epilogue
   (cuFFT, roll, scale, strided keep).
4. slice: 2 pol x 2^23 samples (bench.py's size) through
   ``PFBRoundTrip`` on the kernels: analysis_fused and inversion_fused
   launch once each and nothing else, the output is
   finite and matches the plain chain on the card (1.2e-5 * scale) and, on a
   2^19-sample prefix, the fp64 numpy oracle (3e-6 * scale, the tolerance of
   tests/test_synthesis.py:37).
5. purity: an integer-bin tone and an impulse through the kernels, scored
   with verify.util.DomainPerformance; max spurious <= -60 dB.
6. dada: fine channels -> io.dada save/load -> fused inversion, equal to the
   direct inversion; then no fallback: one low forward with the plain
   versions and ``torch.fft`` patched to raise; then, under the same patch,
   the other inversion geometries the JAX package's fused path takes (512
   and 128 channels at 4/3, 256 channels at 8/7 with L = 256 and with
   L = 512, SKA-Mid's 256-channel groups): each runs on the frontend kernel
   and the cluster epilogue (n1 = 192, 448) or the out-of-core pair (98304
   points; 114688 points at 896 x 128), within 1.2e-5 * scale of the plain
   inversion.
7. SKA-Mid (``mid_round_trip``: 4096 ch, OS 8/7, the 100353-tap
   zero-padded analysis, L=512 / overlap 128, 1,835,008-point epilogue) at
   bench.py's size, 2 pol x 4,587,520 samples:
   a. kernels: the padded fold (also at an odd, ragged stream length) and
      channel DFT (1e-5 * scale,
      tests/test_pallas.py:268), the frontend at mid shapes (1.2e-5), both
      out-of-core IFFT launches and their pair, with and without ``elem``
      (1e-4, tests/test_pallas.py:423), each against its plain version,
      with both times; each kernel and the pair also back to back and, from
      torch.profiler, each launch's device time;
   b. slice: one forward through the module: every mid launch counter
      rises, the output (2, 1, 4 * 917504) is finite and matches the plain
      chain (1.2e-5 * scale);
   c. oracle: one inversion block against the fp64 numpy oracle (max
      1e-6, mean 2e-7 * scale; tests/test_mid_production.py:144-145);
   d. purity: the tone at 4288/2^19 peaks in bin 4288 and the impulse on
      the block seam at offset - (output_overlap - 1), both <= -60 dB;
   e. no fallback: one forward with the plain versions and ``torch.fft``
      patched to raise;
   f. timing: the mid kernel chain and plain chain, as in phase 8.
8. timing: the low kernel chain and the plain chain (CUDA events, warm-up,
   median of repetitions), in Msamples/s with the card's name and limit.
   b. bench: ``python -m ska_pst_dsp_tpu_torch.bench``'s ``main()`` in a
      process of its own with ``jax`` unimportable, at bench.py's sizes:
      its one JSON line parsed and checked (the schema; low and mid
      Msamples/s, each 0 < pct_sol <= 100 against the card's own peaks; the
      round trip's kernels launched once a call, no epilogue composed; low
      within 3e-6 of the fp64 oracle, mid within 1e-6 max and 2e-7 mean;
      the card nvidia-smi names; the low median ms a call back to back not
      above 1.1 x phase 8's one-call median) and logged.
9. streaming: ``FilterBank`` then ``InverseFilterBank`` over blocks of
   1,000,000 samples, low (2 x 2^23) and mid (2 x 4,587,520), with the
   plain versions and ``torch.fft`` patched to raise: every expected launch
   counter rises, streamed spectra and inversion equal the one-shot drop-ins
   to 1e-6 * scale; chain, host and device time per block.
10. two-stage: the low cascade's inverted cases (oversampled: cluster
    epilogue; critical: composed epilogue, 36864 points; critical with
    combine 16: the ifft_big pair at 589824 points), 2 pol x 2^25 samples
    in 4 blocks, each within 3e-5 * scale of the same chain on the plain
    versions; the oversampled tone and impulse pass TestPureTone and
    TestImpulse at -60 dB; each kernel at the cascades' geometries and the
    corner turn, timed against its plain version, bound and library call.
11. sps -> lowpsi: the SKA-Low PST chain (LowCBF over 512 streams, the
    216-channel monotonic inversion on the fused inversion), as phase 10. Then
    the LowCBF route on the card (the analysis kernel with the quarter-turn
    table) against the port's fp64 oracle
    (``oracle.polyphase_analysis_lowcbf``) over every spectrum, at 2e-6
    (tests/test_analysis.py:36): 2 pol x 2^23 seeded noise on the first
    call and its 2^20 prefix on a later call, max |err| / max |ref|; 8 of
    the 512 sps stage-1 streams (chosen by seed) of the first block, each
    stream's max |err| over its peak across all 256 channels, before 216
    are kept (some streams hold most of their power in the discarded edge
    channels, where fp32 rounding still reaches the kept ones; the ratio to
    the kept peak is printed beside). Each call with the plain versions and
    torch.fft patched to raise, launching analysis_fused once; the card's
    ms and the oracle's s.
11b. channel-major: the analysis's channel-major store at the
    lowpsi.cascade cell's shapes (sps over 2 x (2^26 + a carry); LowCBF's
    216 kept bins over 512 streams), bitwise the time-major store with
    torch's index_select and transpose, timed beside it, beside those torch
    copies and beside its plain version (at 1/16 of the shape); two blocks
    of 2 x 2^26 through the cascade bitwise the same cascade over
    time-major stages (outputs, states, the inverse's outputs), two
    channel-major launches a block and no corner-turn bytes. Its entry
    joins the kernels line.
12. dedispersion: the chirp as the epilogue's ``elem`` (low: cluster
    epilogue, dm 1.5; mid: the pair, dm 50) against the plain inversion
    (1.2e-5 / 1e-4 * scale), and block-wise against whole-stream
    dedispersion in dB.
12b. pst-node: the SKA-Low PST node's fused inversion with its chirp table
    at the lowpst.dedisp cell's shapes, on one input and on the held
    samples and the new block as two inputs (bitwise the one-input launch,
    timed beside it); the node over the cell's cycle of requests, its state
    carried, against its plain chain (``run_pst_node``).
12c. pst-long: the fused inversion's plan at L 512 (216 channels, 82,944 =
    216 * 384 points, one block an SM) at the lowpst1909.dedisp cell's
    shapes: 512 slabs of 4 and 8 blocks with the (256, 82,944) chirp table
    of PSR J1909-3744 (DM 10.3919, discard 100 a side, hop 312) against its
    plain version, ms a call and device ms; two inputs bitwise the launch on
    their join; each plan's registers and spills; then the J1909-3744 node
    over the cell's requests at L 512 and at the upstream L 256 (PsiPlan,
    hop 56), ms a request, which is what the frame length buys
    (``run_pst_long``).
13. data_gen: the file-level tools on the card, in a temporary directory,
    with the plain versions and torch.fft patched to raise: at low a
    complex sinusoid of 2 pol x 2^23 through generate_test_vector ->
    channelize -> synthesize (pipeline, then dispose), kernels 1-3, the
    synthesized file within 1.2e-5 * scale of the plain chain on the card
    from the same files, its headers equal to the numpy backend's and, on a
    2^19-sample prefix, the numpy (fp64 oracle) backend within 3e-6 *
    scale; at mid channelize --use-padded (4096 channels, 2 pol x
    4,587,520) then synthesize, kernels 4, 5, 2, 6, 7, within 1.2e-5 *
    scale of plain; StageTimer's read / compute / write seconds and the
    share of the wall time off the device.
14. drivers: test_sgcht -c low and -c lowpsi at their defaults (16 cases
    each) and -c mid's three single-stage entries (at the committed
    report's 1048576-sample blocks), each case with the plain versions
    patched to raise (torch.fft and the plain epilogue left where the
    inversion has no epilogue plan and no fused kernel, the critical
    cascades' 36864 points, whose composed epilogues are counted instead),
    its launches as expected and each
    status equal to the committed products/report.test_sgcht.<cfg>.json;
    current_performance -c low -d both -n 8 --strict (every in-window point
    <= -60 dB); at3 565 at its defaults, each variant's SNR within 0.5 dB
    of the committed products/report.at3_565.json. Each run's seconds.
15. verify: the verification harness, the analysis tools and the on-card
    tools, every run on the card from launch counts set to 0, with the
    plain versions and torch.fft patched to raise but for the composed
    epilogue of a length no package has a plan for (SKA-Low's 3072-point
    channel groups, counted) and dedisperse's whole-stream chirp:
    a. verify.purity -t -f -n 8 at low, the five block-seam impulses, and
       -t -f -n 4 at mid: every judged point (the in-window impulses, the
       tones at whole bins of the measured spectrum) <= -60 dB and > -120;
    b. verify.test_backends -c low and -c mid --use-padded: mean_close 1.0;
    c. verify.test_cross_implementation at low on tests/test_reference_
       anchor.py's vector (442368 samples, tone bin 377475, impulse at
       0.11): impulse, tone and pulsar each with mean > 0.999;
    d. verify.test_dedispersion -c low and -c mid: mean_diff_db < -50;
    e. verify.verify_dspsr_pfb_inversion -c low and -c mid: 12 cases each
       ok at -38 dB; 96 composed 3072-point epilogues at low, none at mid,
       where the 256-channel groups run on the pair at 896 x 128 (timed
       against its plain version, its bound and torch.fft.ifft);
    f. tools/purity_cuda.py -c low -n 16 and -c mid -n 6 (every in-window
       point <= -60 dB) and tools/dedispersion_cuda.py (fused vs composed
       < 1e-4);
    g. analysis.process_test_vectors --generate -n 2 at low, its 3-way
       report (independent_vs_inverted < 1e-5), then
       analysis.compare_dump_files on two of its files.
    Each run's seconds and its worst figure against its gate; reports go to
    a temporary directory.
15b. ingest: the DADA ingest engine (io/native.py, io.dada.load_split:
    a window's raw words read by threads into pinned host memory, copied
    to the card and unpacked there by csrc/dada_unpack.cu):
    a. its three kernels (dada_unpack, lowcbf_unpack, dada_pack) bitwise
       equal to their plain versions at NBIT 8, 16, 32 (and 64 for the TFP
       read), NPOL 1 and 2, NCHAN 1 and 256, an odd count, on a view 333
       samples into its buffer;
    b. files of 2 pol x 2^23 samples at NBIT 8, 16, 32, a 256-channel
       LowCBF file (NBIT 16, 2 x 2^23 complex samples) and a mid file
       (NBIT 8, 2 x 4,587,520), written in a temporary directory;
    c. the main path, launch counts set to 0 just before it, with the
       plain versions and torch.fft patched to raise: the low file (NBIT
       16) -> load_split -> the low round trip (kernels 1-3), the mid file
       -> load_split -> the mid round trip (kernels 4, 5, 2, 6, 7), the
       LowCBF file through load_split, append_split of 2 x 2^23 samples at
       NBIT 16 x 2.5 and its load_split; every kernel of the path launched;
    d. each round trip bitwise equal to the chain on the numpy-loaded
       stream (io.dada.load), the LowCBF read equal to the numpy read, the
       write read back as exactly the quantised stream and its words equal
       to the plain pack;
    e. for each file: the numpy dada.load + to(card) ms and load_split's
       (host clock, median of 3 / 5), and its steps: the threaded read to
       pinned memory (host clock), the pinned H2D (CUDA events; GB/s), the
       unpack, its plain version and the one torch copy that computes it
       (CUDA events) beside its bound; the engine's host read beside it
       with its threads started for each read and with one read in the
       calling thread (host clock, taking turns, median and min-max).
16. parallel: the sharded pipelines (parallel/) on ranks spawned by
    parallel.distributed.spawn, after the parent has built the kernels:
    NCCL where every rank has a card of its own, else gloo with the ranks
    sharing cuda:0 and every payload staged through host memory (printed
    per world). Inside every rank the plain versions and torch.fft raise.
    World 1 (NCCL on one card): the low round trip at 2 x 8,386,560. Worlds
    2 and 4: the low round trip time-sharded and on the 2 x 1 / 2 x 2 and
    4 x 1 meshes, the mid chain (100353 taps, 2 x 4,587,520) time-sharded
    and on the 2 x 1 / 2 x 2 mesh, each gathered output within 1e-6 *
    scale of the one-shot kernel chain; at world 4 also low x low critical
    combine 16 (2 x 16,776,192: 2^23 gives no combine-16 inversion block)
    and sps -> lowpsi (2 x 8,377,344) within 1e-4 relative of the one-shot
    two-stage models, and sharded_file_round_trip on a low DADA file (each
    rank's window through the ingest engine, dada_unpack) within 1e-6 *
    scale of the one-shot chain. Each gathered output holds exactly
    the samples its geometry gives (parallel_length), every one compared.
    Every rank launched exactly the case's kernels. Then entry.dryrun_multichip(4) under the same guard,
    cli.scaling_bench --world 1 2 4 into a temporary directory, and
    analysis.param_opt --study pipeline on the card, each figure above
    -100 dB within 0.5 dB of products/param_opt.pipeline.json. Per case:
    seconds, each rank's compute and exchange ms (CUDA events; an
    exchange's time includes its staging through host memory), the bytes
    of each exchange, the error against its gate, beside the card's name
    and power limit.

Every bound is taken against the card's peaks from the bench's table
(``bench.PEAKS``, by ``torch.cuda.get_device_name``). The line before the
last is a JSON object with one entry per kernel (one per pallas_call of the
JAX package, the fused inversion, then the ingest engine's three); the last
line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

N_DAT = 2 ** 23
PREFIX = 2 ** 19
SEED = 0
ANALYSIS_TOL = 8e-6
SYNTHESIS_TOL = 1.2e-5
ORACLE_TOL = 3e-6
PADDED_TOL = 1e-5
BIG_IFFT_TOL = 1e-4
MID_ORACLE_MAX, MID_ORACLE_MEAN = 1e-6, 2e-7
#: the lowpsi.cascade cell's block a polarisation, and a carry of stage 1
CELL_BLOCK, SPS_CARRY = 2 ** 26, 7168
PURITY_DB = -60.0
REPS = 10
PALLAS = "ska_pst_dsp_tpu/ops/pallas/"
#: registers and spills of each source's kernels, from the build
RESOURCES = {}
#: the bench phase's command: the port's bench with JAX unimportable
BENCH_CMD = ("import sys; sys.modules['jax'] = None; "
             "from ska_pst_dsp_tpu_torch import bench; bench.main()")
#: the bench's low ms per call may exceed phase 8's one-call median by this
#: factor at most: back to back it hides the host's work
BENCH_VS_ONE_CALL = 1.1


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


def back_to_back_ms(torch, fn, calls: int = 20, windows: int = 5) -> float:
    """Median over ``windows`` of the time per call of ``calls`` calls in a
    row, timed with CUDA events: the host's work overlaps the card's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(torch, fn, match: str, calls: int = 5) -> dict:
    """{kernel: device ms per call} over ``calls`` calls, from torch.profiler,
    for the kernels whose name holds ``match``; {} where the profiler saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us and match in ev.key and not ev.key.startswith("cuda"):
            name = ev.key.split("(")[0].removeprefix("void ")
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32)
            + 1j * rng.standard_normal(shape, dtype=np.float32)).astype(np.complex64)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fft_flops(n: int, count: int) -> float:
    """5 n log2 n per complex n-point transform, ``count`` transforms."""
    return 5.0 * n * math.log2(n) * count


@functools.lru_cache(maxsize=None)
def card_peaks():
    """(HBM bytes/s, fp32 flop/s outside the tensor cores) of the card, from
    the bench's table (``bench.PEAKS``); a card not in it raises."""
    import torch
    from ska_pst_dsp_tpu_torch.bench import peaks

    return peaks(torch.cuda.get_device_name(0))


def bound(n_bytes: int, flops: float):
    """(ms, "bytes" or "operations"): the least time the card could take for
    work that moves n_bytes (each input read once, each output written once)
    and does ``flops`` fp32 operations at the card's peaks, the larger of
    the two times."""
    hbm, fp32 = card_peaks()
    tb, to = n_bytes / hbm * 1e3, flops / fp32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def compare(name, err, tol, ms, plain_ms, bnd=None, library_ms=None):
    check(err[1] <= tol, f"{name}: max|err|/scale {err[1]:.3g} > {tol}")
    extra = "" if bnd is None else f", bound {bnd[0]:.4f} ms ({bnd[1]})"
    if library_ms is not None:
        extra += f", library {library_ms:.4f} ms"
    log("kernels", f"{name}: max|err| {err[0]:.3g}, /scale {err[1]:.3g} "
        f"(tol {tol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{extra}")


def wrappers():
    """Every kernel wrapper, by the name of its kernels-line entry."""
    from ska_pst_dsp_tpu_torch.ops import kernels

    return kernels.wrappers()


def counted_forward(torch, model, x):
    """One forward with every launch count set to 0 just before it: its
    output and the launch counts just after."""
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    out = model(x)
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in ws.items()}


def kernel_entry(name, source, replaces, err, tol, ms, plain_ms, bnd, library_ms):
    """Check one kernel against its plain version; its JSON entry. replaces
    is the file:line of the code it replaces; bnd is (bound ms, what bounds
    it); library_ms the time of one torch call that computes the same
    function (a yardstick the port never calls), or None."""
    compare(name, err, tol, ms, plain_ms, bnd, library_ms)
    return {"name": name, "route": "cuda",
            "source": f"ska_pst_dsp_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "max_abs_err": err[0],
            "max_rel_err": err[1], "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms,
            "resources": RESOURCES.get(source, {})}


def frames_fft(torch, frame, x_tc, t_taper, perm, L, keep, nb):
    """Library yardstick of the frontend: one torch.fft.fft of its tapered
    frames, built beforehand. Returns (the call, its ms, the frame count)."""
    frames = (frame(x_tc.index_select(-1, perm).transpose(1, 2), L, keep, nb)
              .transpose(1, 2) * t_taper).contiguous()

    def call():
        return torch.fft.fft(frames, dim=-1)

    return call, time_ms(torch, call), frames.shape[0] * frames.shape[1] * frames.shape[2]


def more_times(torch, name, kern, lib, match, smi):
    """The kernel and its library call (None where there is none) back to
    back, and the kernel's device time per call from torch.profiler; logged
    and returned."""
    out = {"back_to_back_ms": back_to_back_ms(torch, kern),
           "library_back_to_back_ms": None if lib is None else back_to_back_ms(torch, lib),
           "device_ms": device_ms(torch, kern, match)}
    lib_b2b = ("none" if lib is None else f"{out['library_back_to_back_ms']:.4f} ms")
    log("kernels", f"{name}: back to back {out['back_to_back_ms']:.4f} ms (library "
        f"{lib_b2b}); device time per call: "
        + (", ".join(f"{k} {v:.4f} ms" for k, v in out["device_ms"].items())
           or "not measured") + f" ({smi})")
    return out


#: the torch.fft functions the no-fallback patches replace
FFT_NAMES = ("fft", "ifft", "fftn", "ifftn", "rfft", "irfft", "fft2", "ifft2")


@contextlib.contextmanager
def plain_versions_raise(torch, composed: bool = False):
    """Patches the plain versions, wherever the port's modules hold them,
    and torch.fft to raise; yields the count of names patched. With
    ``composed`` the plain epilogue and torch.fft stay: the path runs a
    geometry neither package has an epilogue plan for."""
    def boom(*args, **kwargs):
        raise AssertionError("a plain version ran on the CUDA path")

    plain = ("padded_fold", "chan_dft_core", "frontend", "epilogue",
             "big_ifft_inner", "big_ifft_outer", "analysis_core", "dada_unpack_core",
             "lowcbf_unpack_core", "dada_pack_core")
    if composed:
        plain = tuple(p for p in plain if p != "epilogue")
    with contextlib.ExitStack() as stack:
        patched = 0
        for mod_name, mod in list(sys.modules.items()):
            if mod_name.startswith("ska_pst_dsp_tpu_torch"):
                for name in plain:
                    if hasattr(mod, name):
                        stack.enter_context(mock.patch.object(mod, name, boom))
                        patched += 1
        if not composed:
            for name in FFT_NAMES:
                stack.enter_context(mock.patch.object(torch.fft, name, boom))
        yield patched


def no_fallback(torch, model, x, phase):
    """One forward with the plain versions and torch.fft patched to raise:
    the CUDA path never falls back."""
    with plain_versions_raise(torch) as patched:
        out = model(x)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(torch.view_as_real(out)).all()), f"{phase}: no-fallback forward")
    log(phase, f"forward completed with {patched} plain-version names and "
        "torch.fft patched to raise")


def other_geometries(torch, dev):
    """The inversion geometries the JAX package's fused path takes beside
    the two main paths', 40 blocks each: the drop-in runs on the kernels
    alone (the plain versions raise) and agrees with the plain inversion.
    SKA-Mid's 256-channel groups (L 512, 114688 points, whose plan_ifft
    split neither epilogue kernel takes) run on the pair at 896 x 128."""
    from ska_pst_dsp_tpu_torch.design import fir
    from ska_pst_dsp_tpu_torch.ops import synthesis as plain_synth
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import (
        epilogue_plan, polyphase_synthesis_fused,
    )
    from ska_pst_dsp_tpu_torch.utils import geometry
    from ska_pst_dsp_tpu_torch.utils.rational import Rational

    ws = wrappers()
    for n_chan, os_f, n_l, ov in ((512, "4/3", 256, 48), (128, "4/3", 256, 48),
                                  (256, "8/7", 256, 32), (256, "8/7", 512, 128)):
        os_f = Rational.coerce(os_f)
        filt = fir.design_pfb_fir_filter(n_chan, os_f, 4)
        g = geometry.SynthesisGeometry(n_chan, n_l, ov, os_f)
        x = torch.as_tensor(noise((2, n_chan, 2 * ov + 40 * g.input_keep), SEED + n_chan),
                            device=dev)
        kw = dict(input_overlap=ov, deripple_coeff=filt, temporal_taper="tukey")
        ref = plain_synth.polyphase_synthesis(x, n_l, os_f, **kw)
        before = {k: w.launches for k, w in ws.items()}
        with plain_versions_raise(torch):
            got = polyphase_synthesis_fused(x, n_l, os_f, **kw)
            torch.cuda.synchronize()
        ran = sorted(k for k, w in ws.items() if w.launches > before[k])
        check(ran in (["ifft_fused", "synthesis_fused"],
                      ["ifft_big_inner", "ifft_big_outer", "synthesis_fused"]),
              f"{n_chan} channels at {os_f}: launched {ran}")
        err = rel_err(got, ref)
        check(err[1] <= SYNTHESIS_TOL, f"{n_chan} channels at {os_f}: {err[1]:.3g}")
        n, lo, nb = g.output_fft_length, g.output_overlap, g.n_blocks(x.shape[2])
        on_device = device_ms(torch, lambda: polyphase_synthesis_fused(x, n_l, os_f, **kw),
                              "ifft_")
        bnd = bound(2 * nb * (2 * n - 2 * lo) * 8, fft_flops(n, 2 * nb))
        route, n2, n1 = epilogue_plan(n, lo)
        log("geometries", f"{n_chan} ch, OS {os_f}, L {n_l}, overlap {ov}: the {route} "
            f"epilogue at {n2} x {n1}; launched {', '.join(ran)}; max|err|/scale {err[1]:.3g} "
            f"(tol {SYNTHESIS_TOL}); epilogue of 2 x {nb} blocks on the device: "
            + (", ".join(f"{k} {v:.4f} ms" for k, v in on_device.items()) or "not measured")
            + f", bound {bnd[0]:.4f} ms ({bnd[1]})")


def inversion_entry(torch, model, chan, smi):
    """The fused SKA-Low inversion kernel against its plain version (the
    frontend then the epilogue) at the main path's 2 x 272 blocks, with and
    without ``elem``, and at a stream block's batch (2 x 2 blocks of a
    channel-major view), each beside the two-kernel route it replaces
    (synthesis_fused then fused_big_ifft); its kernels-line entry."""
    from ska_pst_dsp_tpu_torch.entry import L, OVERLAP
    from ska_pst_dsp_tpu_torch.ops import synthesis as ps
    from ska_pst_dsp_tpu_torch.ops.kernels import inversion_fused as inv
    from ska_pst_dsp_tpu_torch.ops.kernels.ifft_fused import fused_big_ifft
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import synthesis_fused
    from ska_pst_dsp_tpu_torch.utils import windows

    g = model.geom
    consts = (model.t_taper, model.dr, model.perm)
    keep, kpos = g.input_keep, (L // 2 + g.discard) % L
    n, lo, roll = g.output_fft_length, g.output_overlap, g.fn_width // 2
    gain = g.os_factor.de / g.os_factor.nu
    elem = torch.as_tensor(np.roll(windows.build("tukey", n, OVERLAP), roll)
                           .astype(np.complex64), device=chan.device)
    check(inv.takes(L, chan.shape[2], n, lo), "inversion_fused does not take the low geometry")

    def fused(x_tc, nb, e=None):
        return inv.inversion_fused(x_tc, *consts, e, keep, kpos, nb, lo, roll, gain)

    def plain(x_tc, nb, e=None):
        fn = ps.frontend(x_tc, *consts, L, keep, kpos, nb)
        return ps.epilogue(fn.reshape(x_tc.shape[0], nb, n), e, lo, roll, gain, nb)

    def two_kernels(x_tc, nb):
        fn = synthesis_fused(x_tc, *consts, L, keep, kpos, nb)
        return fused_big_ifft(fn.reshape(x_tc.shape[0], nb, n), None,
                              shape_key=(n, 128, 384, lo, roll, gain), n_valid=nb)

    nb = g.n_blocks(chan.shape[1])
    with_elem = rel_err(fused(chan, nb, elem), plain(chan, nb, elem))
    compare("inversion_fused with elem", with_elem, SYNTHESIS_TOL,
            time_ms(torch, lambda: fused(chan, nb, elem)),
            time_ms(torch, lambda: plain(chan, nb, elem)))
    err = max(rel_err(fused(chan, nb), plain(chan, nb)), with_elem, key=lambda e: e[1])
    flops = fft_flops(L, 2 * nb * chan.shape[2]) + fft_flops(n, 2 * nb)
    out_bytes = 2 * nb * (n - 2 * lo) * 8
    entry = kernel_entry("inversion_fused", "inversion_fused", "none alone: fuses the ports of "
                         + PALLAS + "synthesis_fused.py:244 and " + PALLAS + "ifft_fused.py:268",
                         err, SYNTHESIS_TOL, time_ms(torch, lambda: fused(chan, nb)),
                         time_ms(torch, lambda: plain(chan, nb)),
                         bound(nbytes(chan, *consts) + out_bytes, flops), None)
    entry.update(more_times(torch, "inversion_fused", lambda: fused(chan, nb), None,
                            "inversion_fused_kernel", smi))
    entry["two_kernel_ms"] = time_ms(torch, lambda: two_kernels(chan, nb))
    # the bound with every frame read from device memory, its overlap again
    entry["bound_ms_frames_reread"] = bound(
        2 * nb * chan.shape[2] * L * 8 + out_bytes, flops)[0]
    entry["active_clusters"] = inv.active_clusters()
    # a stream block's batch: 2 pol x 2 inversion blocks of a channel-major view
    nb_s = 2
    cm = torch.as_tensor(noise((2, chan.shape[2], 2 * OVERLAP + nb_s * keep + 5), SEED + 17),
                         device=chan.device)[:, :, 5:].transpose(1, 2)
    serr = rel_err(fused(cm, nb_s), plain(cm, nb_s))
    check(serr[1] <= SYNTHESIS_TOL, f"inversion_fused at a stream batch: {serr[1]:.3g}")
    entry["stream_batch"] = {
        "blocks": 2 * nb_s, "max_rel_err": serr[1], "ms": time_ms(torch, lambda: fused(cm, nb_s)),
        "plain_ms": time_ms(torch, lambda: plain(cm, nb_s)),
        "two_kernel_ms": time_ms(torch, lambda: two_kernels(cm, nb_s)),
        "bound_ms": bound(2 * nb_s * chan.shape[2] * L * 8 + 2 * nb_s * (n - 2 * lo) * 8,
                          fft_flops(L, 2 * nb_s * chan.shape[2]) + fft_flops(n, 2 * nb_s))[0]}
    log("kernels", f"inversion_fused: {entry['active_clusters']} clusters of 8 resident; "
        f"{entry['ms']:.4f} ms one call against the two kernels' {entry['two_kernel_ms']:.4f} "
        f"ms; bound {entry['bound_ms']:.4f} ms (each input read once; "
        f"{entry['bound_ms_frames_reread']:.4f} with every frame read again); stream batch "
        f"of {2 * nb_s} blocks: {entry['stream_batch']['ms']:.4f} ms against the two kernels' "
        f"{entry['stream_batch']['two_kernel_ms']:.4f} ms, max|err|/scale {serr[1]:.3g} "
        f"({smi})")
    return entry


def slab_inversion(torch, dev, smi):
    """The fused inversion at a LowCBF PST slab's geometry (216 monotonic
    channels, 41472 points) at the SKA-Low PST cascade's shapes: 512 slabs
    (2 pol x 256 coarse channels) of 9 and of 18 blocks, read through the
    transposed view of a channel-major buffer as the cascade's inverse hands
    a slab over; against its plain version (the frontend then the epilogue; with
    and without ``elem``) and beside the route it replaces, the frontend
    kernel then the composed epilogue (the library chain: cuFFT, roll,
    scale, the strided keep); ms for one call, the kernel's on the device,
    its bound (each input sample read once, each output written once, the
    FFT flops). Returns {blocks: entry}."""
    from ska_pst_dsp_tpu_torch.ops import synthesis as ps
    from ska_pst_dsp_tpu_torch.ops.kernels import inversion_fused as inv
    from ska_pst_dsp_tpu_torch.ops.kernels import synthesis_fused as tsf
    from ska_pst_dsp_tpu_torch.utils import geometry
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    cfg = load_config("lowpsi")
    n_chan, L, ov, os_f = (cfg.kept_channels, cfg.input_fft_length, cfg.input_overlap,
                           cfg.os_factor)
    g = geometry.SynthesisGeometry(n_chan, L, ov, os_f)
    c = ps.synthesis_constants(n_chan, L, os_f, ov, deripple_coeff=cfg.load_fir_filter_coeff(),
                               temporal_taper="tukey", monotonic=True)
    consts = [torch.as_tensor(c[k], device=dev) for k in ("t_taper", "dr", "perm")]
    keep, kpos = g.input_keep, (L // 2 + g.discard) % L
    n, lo, roll, gain = g.output_fft_length, g.output_overlap, g.fn_width // 2, os_f.de / os_f.nu
    check(inv.takes(L, n_chan, n, lo), "inversion_fused does not take the slab geometry")
    elem = torch.as_tensor(noise((n,), SEED + n_chan), device=dev)
    gen = torch.Generator(device=dev)
    entries = {}
    for nb in (9, 18):
        n_dat = 2 * ov + nb * keep
        gen.manual_seed(SEED + nb)
        x = torch.randn((512, n_chan, n_dat + 64), dtype=torch.complex64, device=dev,
                        generator=gen)[:, :, :n_dat].transpose(1, 2)

        def fused(e=None):
            return inv.inversion_fused(x, *consts, e, keep, kpos, nb, lo, roll, gain)

        def plain(e=None):
            fn = ps.frontend(x, *consts, L, keep, kpos, nb)
            return ps.epilogue(fn.reshape(512, nb, n), e, lo, roll, gain, nb)

        def chain():
            fn = tsf.synthesis_fused(x, *consts, L, keep, kpos, nb)
            return tsf.epilogue_dispatch(fn.reshape(512, nb, n), None, g, spans_nyquist=True,
                                         n_valid=nb)

        err = max(rel_err(fused(), plain()), rel_err(fused(elem), plain(elem)),
                  key=lambda e: e[1])
        check(err[1] <= SYNTHESIS_TOL, f"inversion_fused at the slab, {nb} blocks: {err[1]:.3g}")
        composed = tsf.fused_inversion.composed_epilogues
        chain()
        check(tsf.fused_inversion.composed_epilogues == composed + 1,
              "the slab's two-kernel route composes its epilogue")
        n_tr = 512 * nb
        bnd = bound(nbytes(x, *consts) + n_tr * (n - 2 * lo) * 8,
                    fft_flops(L, n_tr * n_chan) + fft_flops(n, n_tr))
        e = {"blocks": n_tr, "max_rel_err": err[1], "ms": time_ms(torch, fused),
             "plain_ms": time_ms(torch, plain), "library_chain_ms": time_ms(torch, chain),
             "device_ms": device_ms(torch, fused, "inversion_fused_kernel"),
             "bound_ms": bnd[0], "bound_by": bnd[1]}
        entries[nb] = e
        log("kernels", f"inversion_fused at the slab geometry, 512 x {nb} blocks "
            f"(channel-major view): max|err|/scale {err[1]:.3g} (tol {SYNTHESIS_TOL}); "
            f"kernel {e['ms']:.4f} ms, device "
            + (", ".join(f"{k} {v:.4f} ms" for k, v in e["device_ms"].items())
               or "not measured")
            + f"; frontend kernel + composed epilogue {e['library_chain_ms']:.4f} ms; plain "
            f"{e['plain_ms']:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}) ({smi})")
        del x
        torch.cuda.empty_cache()
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ska_pst_dsp_tpu_torch import bench
    from ska_pst_dsp_tpu_torch.io import dada
    from ska_pst_dsp_tpu_torch.utils import geometry, windows
    from ska_pst_dsp_tpu_torch.utils.config import load_config
    from ska_pst_dsp_tpu_torch.verify.util import DomainPerformance
    from ska_pst_dsp_tpu_torch.entry import L, N_CHAN, OS_FACTOR, OVERLAP, low_round_trip
    from ska_pst_dsp_tpu_torch.ops import synthesis as plain_synth
    from ska_pst_dsp_tpu_torch.ops.analysis import analysis_core
    from ska_pst_dsp_tpu_torch.ops.framing import frame
    from ska_pst_dsp_tpu_torch.ops.kernels import _build
    from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import (
        analysis_fused, polyphase_analysis_fused,
    )
    from ska_pst_dsp_tpu_torch.ops.kernels.ifft_big import fused_big_ifft_oc
    from ska_pst_dsp_tpu_torch.ops.kernels.ifft_fused import (
        active_clusters, fused_big_ifft,
    )
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import (
        epilogue_plan, polyphase_synthesis_fused, synthesis_fused,
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
    RESOURCES.update(_build.resource_usage())
    for source, kerns in sorted(RESOURCES.items()):
        log("build", f"{source}: " + "; ".join(
            f"{k} {v['registers']} registers, spills {v['spill_stores']} B stored / "
            f"{v['spill_loads']} B loaded" for k, v in sorted(kerns.items())))

    # 3. kernels against their plain versions at the main path's shapes
    model = low_round_trip(dev)
    g = model.geom
    x = torch.as_tensor(noise((2, N_DAT), SEED), device=dev)
    kernels = []

    def record(name, replaces, err, tol, ms, plain_ms, bnd, library_ms):
        kernels.append(kernel_entry(name, name, PALLAS + replaces, err, tol, ms, plain_ms, bnd,
                                    library_ms))

    def a_kernel():
        return analysis_fused(x, model.f2d, model.ramp, model.step)

    def a_plain():
        return analysis_core(x, model.f2d, model.ramp, model.step)

    chan = a_plain()
    n_spec, phases = 2 * chan.shape[1], model.f2d.shape[0]
    record("analysis_fused",
           "analysis_fused.py:307",
           rel_err(a_kernel(), chan), ANALYSIS_TOL,
           time_ms(torch, a_kernel), time_ms(torch, a_plain),
           bound(nbytes(x, model.f2d, model.ramp, chan),
                 n_spec * N_CHAN * (4 * phases + 6) + fft_flops(N_CHAN, n_spec)), None)
    kernels[-1].update(more_times(torch, "analysis_fused", a_kernel, None,
                                  "analysis_fused_kernel", smi))

    nb = g.n_blocks(chan.shape[1])
    kpos = (L // 2 + g.discard) % L
    fargs = (chan, model.t_taper, model.dr, model.perm, L, g.input_keep, kpos, nb)
    fn = plain_synth.frontend(*fargs)
    lib_call, lib_ms, n_frames = frames_fft(torch, frame, chan, model.t_taper, model.perm,
                                            L, g.input_keep, nb)
    record("synthesis_fused",
           "synthesis_fused.py:244",
           rel_err(synthesis_fused(*fargs), fn), SYNTHESIS_TOL,
           time_ms(torch, lambda: synthesis_fused(*fargs)),
           time_ms(torch, lambda: plain_synth.frontend(*fargs)),
           bound(nbytes(chan, model.t_taper, model.dr, model.perm, fn),
                 fft_flops(L, n_frames) + 2 * L * n_frames), lib_ms)
    kernels[-1].update(more_times(torch, "synthesis_fused", lambda: synthesis_fused(*fargs),
                                  lib_call, "synthesis_frontend_kernel", smi))
    del lib_call

    n, lo, roll = g.output_fft_length, g.output_overlap, g.fn_width // 2
    gain = OS_FACTOR.de / OS_FACTOR.nu
    route, *plan = epilogue_plan(n, lo)
    check((route, *plan) == ("cluster", 128, 384), f"epilogue_plan({n}, {lo}) = {route}, {plan}")
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
    out_bytes = 2 * nb * (n - 2 * lo) * 8
    lib_ms = time_ms(torch, lambda: torch.fft.ifft(flat, dim=-1))
    record("ifft_fused", "ifft_fused.py:268",
           worst, SYNTHESIS_TOL, *results[1][1:],
           bound(nbytes(flat) + out_bytes, fft_flops(n, 2 * nb)), lib_ms)

    def e_main():
        return fused_big_ifft(flat, None, shape_key=(n, *plan, lo, roll, gain), n_valid=nb)

    kernels[-1].update(more_times(torch, "ifft_fused", e_main,
                                  lambda: torch.fft.ifft(flat, dim=-1),
                                  "ifft_cluster_kernel", smi))
    clusters = active_clusters(plan[1])
    # yardstick: the mid path's two-launch ifft_big pair at the low shape, n2 = 1 * 128
    pair_key = (n, 1, plan[0], plan[1], lo, roll, gain)

    def pair_call():
        return fused_big_ifft_oc(flat, None, shape_key=pair_key)

    pair_err = rel_err(pair_call(), plain_synth.epilogue(flat, None, lo, roll, gain, nb))
    check(pair_err[1] <= SYNTHESIS_TOL, f"ifft_big pair at the low shape {pair_err[1]:.3g}")
    ms_main = kernels[-1]["ms"]
    pair = {"ms": time_ms(torch, pair_call), "back_to_back_ms": back_to_back_ms(torch, pair_call),
            "device_ms": device_ms(torch, pair_call, "ifft_big"), "max_rel_err": pair_err[1]}
    kernels[-1].update({"active_clusters": clusters, "yardstick_ifft_big_pair": pair})
    log("kernels", f"ifft_fused: {clusters} clusters of 4 resident on the card; "
        f"{ms_main:.4f} ms one call = {ms_main / lib_ms:.2f}x torch.fft.ifft ({lib_ms:.4f} ms), "
        f"{ms_main / pair['ms']:.2f}x the ifft_big pair at the low shape ({pair['ms']:.4f} ms; "
        f"back to back {pair['back_to_back_ms']:.4f} ms; device "
        + (", ".join(f"{k} {v:.4f} ms" for k, v in pair["device_ms"].items())
           or "not measured") + f"; max|err|/scale {pair_err[1]:.3g}) ({smi})")
    del fn, flat
    kernels.append(inversion_entry(torch, model, chan, smi))
    del chan
    kernels[-1]["slab_216"] = slab_inversion(torch, dev, smi)

    # 4. the slice at full size through the module, then the oracle prefix
    out, launches = counted_forward(torch, model, x)
    log("slice", f"launch counts over one forward of 2 x 2^23: {launches}")
    ran = {k: v for k, v in launches.items() if v}
    check(ran == dict.fromkeys(LOW_KERNELS, 1),
          f"the low forward launched {ran}, expected {LOW_KERNELS} once each")
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
    oerr = bench.low_oracle_error(model, filt, x, PREFIX)
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

    # 6b. no fallback on the low path
    no_fallback(torch, model, x, "fallback")
    other_geometries(torch, dev)

    # 7. SKA-Mid
    mid_entries, mid_front, mid_ms = run_mid(torch, dev, smi)
    next(k for k in kernels if k["name"] == "synthesis_fused").update(mid_front)
    kernels.extend(mid_entries)

    # 8. timing: kernel chain vs plain chain, interleaved
    low_ms = chain_timing(torch, model, x, "timing", "2 x 2^23 samples", smi)
    del model, x, xp
    torch.cuda.empty_cache()

    # 8b. the port's bench in a process of its own, JAX unimportable
    run_bench(smi, low_ms)

    # 9-12. streaming, the two-stage cascades, dedispersion
    run_streaming(torch, dev, smi, {"low": low_ms, "mid": mid_ms})
    run_two_stage(torch, dev, smi)
    run_sps_lowpsi(torch, dev, smi)
    kernels.append(run_channel_major(torch, dev, smi))
    torch.cuda.empty_cache()
    run_dedispersion(torch, dev, smi)
    torch.cuda.empty_cache()
    run_pst_node(torch, dev, smi)
    torch.cuda.empty_cache()
    run_pst_long(torch, dev, smi)
    torch.cuda.empty_cache()

    # 13-14. the file-level data_gen tools and the CLI drivers
    for phase, run in (("data_gen", lambda: run_data_gen(torch, dev, smi)),
                       ("drivers", lambda: run_drivers(torch, smi))):
        t0 = time.perf_counter()
        run()
        log(phase, f"phase done in {time.perf_counter() - t0:.1f} s ({smi})")

    # 15. the verification harness, the analysis tools and the on-card tools
    t0 = time.perf_counter()
    run_verify(torch, dev, smi)
    log("verify", f"phase done in {time.perf_counter() - t0:.1f} s ({smi})")

    # 15b. the DADA ingest engine: files to the card, the round trips on them
    t0 = time.perf_counter()
    kernels.extend(run_ingest(torch, dev, smi))
    log("ingest", f"phase done in {time.perf_counter() - t0:.1f} s ({smi})")

    # 16. the sharded pipelines on spawned ranks
    t0 = time.perf_counter()
    run_parallel(torch, dev, smi)
    log("parallel", f"phase done in {time.perf_counter() - t0:.1f} s ({smi})")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


def chain_timing(torch, model, x, phase, what, smi):
    """The kernel chain and the plain chain in turns (plain, kernels,
    kernels, plain), each the median of REPS CUDA-event timings; returns
    the kernel chain's lesser median, in ms."""
    msps = {}
    for name in ("plain", "kernels", "kernels", "plain"):
        fn_ = model.reference if name == "plain" else model
        ms = time_ms(torch, lambda: fn_(x))
        msps.setdefault(name, []).append((ms, x.numel() / (ms * 1e3)))
    for name, runs in msps.items():
        log(phase, f"{name} chain, {what}: "
            + ", ".join(f"{ms:.3f} ms = {r:.1f} Msamples/s" for ms, r in runs)
            + f" (median of {REPS}; {smi})")
    return min(ms for ms, _ in msps["kernels"])


def run_bench(smi, low_ms):
    """Phase 8b: ``bench.main()`` in a subprocess with ``jax`` unimportable
    (the build is cached by now); its last line checked: the schema, each
    leg's share of its speed of light in (0, 100], the kernels launched
    once a call and no epilogue composed, the errors against the fp64
    oracle, the card it names, and the low ms per call back to back not
    above phase 8's one-call median x BENCH_VS_ONE_CALL. Logged beside the
    card's name and power limit."""
    from ska_pst_dsp_tpu_torch.bench import check_launches

    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", BENCH_CMD], capture_output=True, text=True,
                         timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(run.returncode == 0, f"bench exited {run.returncode}: {run.stderr[-3000:]}")
    line = run.stdout.strip().splitlines()[-1]
    log("bench", line)
    out = json.loads(line)
    check(out["metric"] == "low_roundtrip_throughput" and out["fft_precision"] == "fp32"
          and out["unit"] == out["mid"]["unit"] == "Msamples/s/chip"
          and out["vs_baseline"] > 0 and out["baseline"]["msamples_per_s"] > 0,
          f"bench schema: {sorted(out)}")
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    check(out["device"] == {"name": name, "power_limit_w": float(limit.split()[0])},
          f"bench device {out['device']} vs nvidia-smi {smi}")
    for leg, r in (("low", out), ("mid", out["mid"])):
        roof, ms = r["roofline"], r["ms_per_call"]
        check(r["value"] > 0 and 0 < roof["pct_sol"] <= 100
              and roof["sol_msps"] == min(roof["sol_mem_msps"], roof["sol_fp32_msps"]),
              f"bench {leg}: {r['value']} Msamples/s, roofline {roof}")
        check(ms["min"] <= ms["median"] <= ms["max"], f"bench {leg}: ms per call {ms}")
        check(set(r["launches_per_call"]) == {*wrappers(), "composed_epilogues"},
              f"bench {leg}: launches per call {r['launches_per_call']}")
        check_launches(leg, r["launches_per_call"])
    check(out["max_err_vs_oracle"] <= ORACLE_TOL, f"bench low vs oracle {out['max_err_vs_oracle']}")
    err = out["mid"]["max_err_vs_oracle"]
    check(err["max"] <= MID_ORACLE_MAX and err["mean"] <= MID_ORACLE_MEAN,
          f"bench mid vs oracle {err}")
    low = out["ms_per_call"]["median"]
    check(low <= low_ms * BENCH_VS_ONE_CALL,
          f"bench low {low:.4f} ms a call back to back > {BENCH_VS_ONE_CALL} x phase 8's "
          f"one-call {low_ms:.4f} ms")
    log("bench", f"low {out['value']} Msamples/s ({low:.4f} ms a call, phase 8 one call "
        f"{low_ms:.4f} ms), {out['roofline']['pct_sol']} % of {out['roofline']['sol_msps']}; "
        f"mid {out['mid']['value']} Msamples/s ({out['mid']['ms_per_call']['median']:.4f} ms), "
        f"{out['mid']['roofline']['pct_sol']} % of {out['mid']['roofline']['sol_msps']}; "
        f"vs_baseline {out['vs_baseline']}; errors vs oracle low {out['max_err_vs_oracle']:.3g}, "
        f"mid max {err['max']:.3g} mean {err['mean']:.3g}; "
        f"{time.perf_counter() - t0:.1f} s with JAX unimportable ({smi})")


def run_mid(torch, dev, smi):
    """Phase 7: the SKA-Mid slice. Returns the JSON entries of its four new
    kernels and the frontend's mid numbers."""
    from ska_pst_dsp_tpu_torch import bench
    from ska_pst_dsp_tpu_torch.utils import windows
    from ska_pst_dsp_tpu_torch.utils.config import load_config
    from ska_pst_dsp_tpu_torch.entry import mid_round_trip
    from ska_pst_dsp_tpu_torch.ops import synthesis as ps
    from ska_pst_dsp_tpu_torch.ops.analysis import chan_dft_core, padded_fold
    from ska_pst_dsp_tpu_torch.ops.framing import frame
    from ska_pst_dsp_tpu_torch.ops.kernels.analysis_padded_fused import padded_fold_fused
    from ska_pst_dsp_tpu_torch.ops.kernels.chan_dft_fused import chan_dft_ramp
    from ska_pst_dsp_tpu_torch.ops.kernels.ifft_big import (
        fused_big_ifft_oc, ifft_big_inner, ifft_big_outer,
    )
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import epilogue_plan, synthesis_fused

    model = mid_round_trip(dev)
    g = model.geom
    L, ov, step = g.input_fft_length, g.input_overlap, model.step
    n_dat = (2 * ov + 4 * g.input_keep) * step  # bench.py's mid size
    x = torch.as_tensor(noise((2, n_dat), SEED), device=dev)
    entries = []

    # a. each kernel against its plain version at production shapes
    fold_args = (x, model.f2d_rev, step)
    fold = padded_fold(*fold_args)
    entries.append(kernel_entry(
        "analysis_padded_fused", "analysis_padded_fused", PALLAS + "analysis_padded_fused.py:257",
        rel_err(padded_fold_fused(*fold_args), fold), PADDED_TOL,
        time_ms(torch, lambda: padded_fold_fused(*fold_args)),
        time_ms(torch, lambda: padded_fold(*fold_args)),
        bound(nbytes(x, model.f2d_rev, fold), 4 * model.f2d_rev.shape[0] * fold.numel()),
        None))
    entries[-1].update(more_times(torch, "analysis_padded_fused",
                                  lambda: padded_fold_fused(*fold_args), None,
                                  "padded_fold_kernel", smi))
    # an odd stream length that is no multiple of the row width: the wrapper
    # copies it to an even polarization stride, the last tile is ragged
    xr = x[:, :1000 * step + 1237].contiguous()
    err = rel_err(padded_fold_fused(xr, model.f2d_rev, step),
                  padded_fold(xr, model.f2d_rev, step))
    check(err[1] <= PADDED_TOL, f"padded fold at 2 x {xr.shape[1]}: {err[1]:.3g}")
    log("kernels", f"analysis_padded_fused at 2 x {xr.shape[1]} samples (odd, ragged): "
        f"max|err|/scale {err[1]:.3g} (tol {PADDED_TOL})")
    del xr
    cargs = (fold, model.chan_const, 0, model.delay)
    chan = chan_dft_core(*cargs)
    block = fold.shape[-1]
    entries.append(kernel_entry(
        "chan_dft_fused", "chan_dft_fused", PALLAS + "chan_dft_fused.py:190",
        rel_err(chan_dft_ramp(*cargs), chan), PADDED_TOL,
        time_ms(torch, lambda: chan_dft_ramp(*cargs)),
        time_ms(torch, lambda: chan_dft_core(*cargs)),
        bound(nbytes(fold, model.chan_const, chan),
              fft_flops(block, fold.numel() // block) + 6 * fold.numel()),
        time_ms(torch, lambda: torch.fft.fft(fold, dim=-1))))
    entries[-1].update(more_times(torch, "chan_dft_fused", lambda: chan_dft_ramp(*cargs),
                                  lambda: torch.fft.fft(fold, dim=-1), "chan_dft_kernel",
                                  smi))
    del fold, cargs

    nb = g.n_blocks(chan.shape[1])
    fargs = (chan, model.t_taper, model.dr, model.perm, L, g.input_keep,
             (L // 2 + g.discard) % L, nb)
    fn = ps.frontend(*fargs)
    front_err = rel_err(synthesis_fused(*fargs), fn)
    front_ms = (time_ms(torch, lambda: synthesis_fused(*fargs)),
                time_ms(torch, lambda: ps.frontend(*fargs)))
    lib_call, lib_ms, n_frames = frames_fft(torch, frame, chan, model.t_taper, model.perm,
                                            L, g.input_keep, nb)
    front_bound = bound(nbytes(chan, model.t_taper, model.dr, model.perm, fn),
                        fft_flops(L, n_frames) + 2 * L * n_frames)
    compare("synthesis_fused at mid", front_err, SYNTHESIS_TOL, *front_ms, front_bound,
            lib_ms)
    mid_front = {"mid_max_abs_err": front_err[0], "mid_max_rel_err": front_err[1],
                 "mid_ms": front_ms[0], "mid_plain_ms": front_ms[1],
                 "mid_bound_ms": front_bound[0], "mid_library_ms": lib_ms}
    mid_front.update({f"mid_{k}": v for k, v in more_times(
        torch, "synthesis_fused at mid", lambda: synthesis_fused(*fargs), lib_call,
        "synthesis_frontend_kernel", smi).items()})
    del chan, fargs, lib_call

    n, lo, roll = g.output_fft_length, g.output_overlap, g.fn_width // 2
    gain = model.os_factor.de / model.os_factor.nu
    route, n2, n1 = epilogue_plan(n, lo)
    check((route, n2, n1) == ("pair", 3584, 512), f"epilogue_plan({n}, {lo}) = {route}, "
          f"{n2} x {n1}")
    flat = fn.reshape(2, nb, n)
    del fn
    elem = torch.as_tensor(np.roll(windows.build("tukey", n, ov), roll)
                           .astype(np.complex64), device=dev)
    key = (n, 1, n2, n1, lo, roll, gain)
    errs, times = {}, {}
    for e in (elem, None):  # the main path's epilogue has no elem: last
        a = ps.big_ifft_inner(flat, e, n2, n1).contiguous()  # the kernel's layout
        runs = {
            "ifft_big_inner": (lambda: ifft_big_inner(flat, e, n2, n1),
                               lambda: ps.big_ifft_inner(flat, e, n2, n1)),
            "ifft_big_outer": (lambda: ifft_big_outer(a, lo, roll, gain),
                               lambda: ps.big_ifft_outer(a, lo, roll, gain)),
            "ifft_big pair": (lambda: fused_big_ifft_oc(flat, e, shape_key=key),
                              lambda: ps.epilogue(flat, e, lo, roll, gain, nb)),
        }
        for name, (kern, plain) in runs.items():
            err = rel_err(kern(), plain())
            times[name] = (time_ms(torch, kern), time_ms(torch, plain))
            compare(f"{name} {'no elem' if e is None else 'with elem'}", err,
                    BIG_IFFT_TOL, *times[name])
            errs[name] = max(errs.get(name, err), err, key=lambda v: v[1])
        del a, runs
    # bounds from this run's tensors (the main path has no elem), the
    # library calls, and the pair back to back and on the device
    n_tr = flat.shape[0] * flat.shape[1]
    a_bytes, out_bytes = n_tr * n * 8, n_tr * (n - 2 * lo) * 8
    bounds = {
        "ifft_big_inner": bound(nbytes(flat) + a_bytes, fft_flops(n2, n1 * n_tr)),
        "ifft_big_outer": bound(a_bytes + out_bytes, fft_flops(n1, n2 * n_tr) + 6 * n * n_tr),
        "ifft_big pair": bound(nbytes(flat) + out_bytes, fft_flops(n, n_tr)),
    }
    cols = flat.view(*flat.shape[:2], n2, n1)
    library = {"ifft_big_inner": time_ms(torch, lambda: torch.fft.ifft(cols, dim=-2)),
               "ifft_big_outer": None,
               "ifft_big pair": time_ms(torch, lambda: torch.fft.ifft(flat, dim=-1))}

    def pair_call():
        return fused_big_ifft_oc(flat, None, shape_key=key)

    b2b = {"ifft_big pair": back_to_back_ms(torch, pair_call),
           "torch.fft.ifft": back_to_back_ms(torch, lambda: torch.fft.ifft(flat, dim=-1))}
    on_device = device_ms(torch, pair_call, "ifft_big")
    a_main = ps.big_ifft_inner(flat, None, n2, n1).contiguous()
    each = {"ifft_big_inner": more_times(torch, "ifft_big_inner",
                                         lambda: ifft_big_inner(flat, None, n2, n1),
                                         lambda: torch.fft.ifft(cols, dim=-2),
                                         "ifft_big_inner", smi),
            "ifft_big_outer": more_times(torch, "ifft_big_outer",
                                         lambda: ifft_big_outer(a_main, lo, roll, gain), None,
                                         "ifft_big_outer", smi)}
    del flat, elem, cols, a_main
    pair_ms, pb, plib = times["ifft_big pair"][0], bounds["ifft_big pair"], library["ifft_big pair"]
    pair = {"ms": pair_ms, "plain_ms": times["ifft_big pair"][1], "bound_ms": pb[0],
            "library_ms": plib, "back_to_back_ms": b2b, "device_ms": on_device}
    log("mid-kernels", f"ifft_big pair: {pair_ms:.4f} ms, {100 * pb[0] / pair_ms:.1f} % of "
        f"its {pb[0]:.4f} ms bound ({pb[1]}), {pair_ms / plib:.2f}x torch.fft.ifft "
        f"({plib:.4f} ms); back to back: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in b2b.items()) + "; device time per call: "
        + (", ".join(f"{k} {v:.4f} ms" for k, v in on_device.items()) or "not measured")
        + f" ({smi})")
    for name, line in (("ifft_big_inner", 388), ("ifft_big_outer", 524)):
        entry = kernel_entry(name, "ifft_big", f"{PALLAS}ifft_big.py:{line}", errs[name],
                             BIG_IFFT_TOL, *times[name], bounds[name], library[name])
        entry.update(each[name])
        entry["pair"] = pair
        entries.append(entry)

    # b. the slice through the module
    out, launches = counted_forward(torch, model, x)
    log("mid-slice", f"launch counts over one forward of 2 x {n_dat}: {launches}")
    for entry in entries:
        check(launches[entry["name"]] > 0, f"{entry['name']} was not launched by the mid path")
        entry["launches"] = launches[entry["name"]]
    check(launches["synthesis_fused"] > 0, "synthesis_fused was not launched by the mid path")
    mid_front["mid_launches"] = launches["synthesis_fused"]
    shape = (2, 1, 4 * g.output_keep)
    check(tuple(out.shape) == shape, f"mid output shape {tuple(out.shape)} != {shape}")
    check(bool(torch.isfinite(torch.view_as_real(out)).all()), "non-finite mid output")
    err = rel_err(out, model.reference(x))
    check(err[1] <= SYNTHESIS_TOL, f"mid kernel chain vs plain chain {err[1]:.3g}")
    log("mid-slice", f"output {tuple(out.shape)} finite; vs plain chain max|err| "
        f"{err[0]:.3g}, /scale {err[1]:.3g} (tol {SYNTHESIS_TOL})")
    del out

    # c. one inversion block against the fp64 oracle (test_mid_production.py:114-145)
    filt = load_config("mid").load_fir_filter_coeff()
    nfine = 2 * ov + g.input_keep
    d_max, d_mean = bench.mid_oracle_error(model, filt, seed=7)
    check(d_max <= MID_ORACLE_MAX and d_mean <= MID_ORACLE_MEAN,
          f"mid kernel chain vs fp64 oracle: max {d_max:.3g}, mean {d_mean:.3g}")
    log("mid-oracle", f"one block ({nfine * step} samples) vs fp64 oracle: max|err|/scale "
        f"{d_max:.3g} (tol {MID_ORACLE_MAX}), mean {d_mean:.3g} (tol {MID_ORACLE_MEAN})")

    # d. purity through the kernels (test_mid_production.py:66-112)
    freq = 4288 / 2 ** 19  # channel 33.5 of 4096: an exact bin of a 2^19 FFT
    tone = np.exp(2j * np.pi * freq * np.arange(nfine * step)).astype(np.complex64)
    inv = model(torch.as_tensor(tone[None], device=dev)).cpu().numpy()[0, 0]
    spec = np.abs(np.fft.fft(inv[:2 ** 19])) ** 2
    pk = int(spec.argmax())
    check(pk == 4288, f"mid tone peak in bin {pk}, expected 4288")
    peak = spec[pk]
    spec[pk - 1: pk + 2] = 0.0
    tone_db = 10 * np.log10(spec.max() / peak)
    shift = g.output_overlap - 1
    offset = shift + g.output_keep  # on the seam of two inversion blocks
    imp = np.zeros((2 * ov + 2 * g.input_keep) * step, np.complex64)
    imp[offset] = 1.0
    inv = model(torch.as_tensor(imp[None], device=dev)).cpu().numpy()[0, 0]
    p = np.abs(inv) ** 2
    pk = int(p.argmax())
    check(pk == offset - shift, f"mid impulse at {pk}, expected {offset - shift}")
    leak = p.copy()
    leak[pk - 1: pk + 2] = 0.0
    imp_db = 10 * np.log10(leak.max() / p[pk])
    log("mid-purity", f"tone 4288/2^19: peak bin 4288, max spurious {tone_db:.2f} dB; "
        f"impulse on the block seam: peak at offset - {shift}, leakage {imp_db:.2f} dB")
    check(max(tone_db, imp_db) <= PURITY_DB, f"mid purity {max(tone_db, imp_db):.2f} dB")

    # e. no fallback: the plain versions and torch.fft raise during a forward
    no_fallback(torch, model, x, "mid-fallback")

    # f. timing
    ms = chain_timing(torch, model, x, "mid-timing", f"2 x {n_dat} samples", smi)
    return entries, mid_front, ms


# ---------------------------------------------------------------------------
# phases 9-12: streaming, the two-stage cascades and dedispersion
# ---------------------------------------------------------------------------

#: bench.py's mid size, 2 pol x (2 * 128 + 4 * 256) * 3584 samples
MID_N_DAT = 4_587_520
STREAM_BLOCK = 1_000_000  # a multiple of neither 192 nor 3584: the carry works
STREAM_TOL = 1e-6
CASCADE_TOL = 3e-5
CASCADE_N_DAT, CASCADE_BLOCKS = 2 ** 25, 4
#: the cascades' tone: 257/1024 lies a quarter channel off coarse channel
#: 64's centre, an exact bin after each stage's baseband shift
TONE = 257 / 1024
IMPULSE_AT = 2 ** 23 + 777
#: coherent dedispersion (tools/dedispersion_tpu.py:57-64): low at dm 1.5,
#: whose 7184-sample band delay fits low's 9216-sample overlap; mid at dm 50,
#: 239469 samples inside mid's 458752
DM_LOW, DM_MID, F0_MHZ, BW_MHZ = 1.5, 50.0, 1405.0, 40.0
DEDISP_TOL = {"low": 1.2e-5, "mid": 1e-4}
#: LowCBF on the card against the fp64 oracle, max |err| / max |ref|
#: (tests/test_analysis.py:36, used at :121-139)
LOWCBF_ORACLE_TOL = 2e-6
LOWCBF_PREFIX, LOWCBF_STREAMS = 2 ** 20, 8


def events(torch):
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def reset_counts():
    """Every launch count and the composed-epilogue count set to 0; the
    wrappers."""
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import fused_inversion

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    fused_inversion.composed_epilogues = 0
    return ws


def read_counts(torch, ws):
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import fused_inversion

    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in ws.items()}
    counts["composed_epilogues"] = fused_inversion.composed_epilogues
    return counts


def expect_launches(phase, counts, kernels, composed):
    """The path launched exactly ``kernels``, each at least once; the
    composed epilogue ran once per inversion where ``composed``, else
    never."""
    ran = sorted(k for k, v in counts.items() if v > 0 and k != "composed_epilogues")
    check(ran == sorted(kernels), f"{phase}: launched {ran}, expected {sorted(kernels)}")
    want = counts["synthesis_fused"] if composed else 0
    check(counts["composed_epilogues"] == want,
          f"{phase}: {counts['composed_epilogues']} composed epilogues, expected {want}")


def breakdown(torch, fn):
    """(device busy ms, "name ms, ..." of the five largest, ms of host <->
    device copies) of one call of fn, from torch.profiler: every kernel and
    copy on the card, by name (template arguments and namespaces dropped)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us and not ev.key.startswith(("aten::", "cuda")):
            key = (ev.key.removeprefix("void ").replace("at::native::", "")
                   .replace("(anonymous namespace)::", ""))
            name = key.split("<")[0].split("(")[0] or key[:40]
            times[name] = times.get(name, 0.0) + us / 1e3
    top = sorted(times.items(), key=lambda kv: -kv[1])[:5]
    copies = sum(v for k, v in times.items() if k.startswith("Memcpy"))
    return sum(times.values()), ", ".join(f"{k} {v:.3f}" for k, v in top), copies


def run_streaming(torch, dev, smi, one_shot_ms):
    """Phase 9: FilterBank then InverseFilterBank over blocks of 1,000,000
    samples, low (2 x 2^23) and mid (2 x 4,587,520), on the kernels (the
    plain versions and torch.fft raise). The streamed spectra equal the
    one-shot drop-in's and the streamed inversion the one-shot fused
    inversion of the same spectra, to 1e-6 * scale."""
    from ska_pst_dsp_tpu_torch.models import FilterBank, GaussianNoise, InverseFilterBank
    from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import polyphase_analysis_fused
    from ska_pst_dsp_tpu_torch.ops.kernels.analysis_padded_fused import (
        polyphase_analysis_padded_fused,
    )
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import polyphase_synthesis_fused
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    kernels = {"low": LOW_KERNELS,
               "mid": ("analysis_padded_fused", "chan_dft_fused", "synthesis_fused",
                       "ifft_big_inner", "ifft_big_outer")}
    for name, n_dat in (("low", N_DAT), ("mid", MID_N_DAT)):
        cfg = load_config(name)
        filt = cfg.load_fir_filter_coeff()
        x = GaussianNoise(seed=SEED, n_pol=2, device=dev).generate(0, n_dat)[:, 0]
        fb, inv = FilterBank(cfg, device=dev), InverseFilterBank(cfg, device=dev)

        def stream():
            """One pass over the stream from fresh states: the spectra, the
            inverted stream, and per block the chain's ms (CUDA events) and
            the host's ms to issue it."""
            fs, ist = fb.init_state(), inv.init_state()
            chans, outs, marks, host = [], [], [], []
            for a in range(0, n_dat, STREAM_BLOCK):
                ev = events(torch)
                t0 = time.perf_counter()
                ev[0].record()
                fs, y = fb.execute(fs, x[:, a:a + STREAM_BLOCK])
                ist, z = inv.execute(ist, y)
                ev[1].record()
                host.append((time.perf_counter() - t0) * 1e3)
                chans.append(y)
                outs.append(z)
                marks.append(ev)
            torch.cuda.synchronize()
            return (torch.cat(chans, 2), torch.cat(outs, 2),
                    [s.elapsed_time(e) for s, e in marks], host)

        stream()  # the first pass builds the inversion's constants and plans
        ws = reset_counts()
        with plain_versions_raise(torch):
            chan, out, ms, host = stream()
        counts = read_counts(torch, ws)
        busy, top, _ = breakdown(torch, stream)
        log("stream", f"{name}: launch counts over the streamed run: {counts}")
        expect_launches(f"stream-{name}", counts, kernels[name], composed=False)
        if name == "low":
            one = polyphase_analysis_fused(x, filt, cfg.channels, cfg.os_factor)
        else:
            one = polyphase_analysis_padded_fused(x, filt, cfg.channels, cfg.os_factor)
        aerr = rel_err(chan, one[:, :, :chan.shape[2]])
        check(aerr[1] <= STREAM_TOL, f"stream-{name}: analysis vs one-shot {aerr[1]:.3g}")
        inv_one = polyphase_synthesis_fused(
            chan, cfg.input_fft_length, cfg.os_factor, input_overlap=cfg.input_overlap,
            deripple_coeff=filt if cfg.deripple else None, temporal_taper=cfg.temporal_taper)
        ierr = rel_err(out, inv_one[:, :, :out.shape[2]])
        check(ierr[1] <= STREAM_TOL, f"stream-{name}: inversion vs one-shot {ierr[1]:.3g}")
        check(out.shape[2] > 0 and bool(torch.isfinite(torch.view_as_real(out)).all()),
              f"stream-{name}: empty or non-finite output")
        log("stream", f"{name}: {chan.shape[2]} spectra, {out.shape[2]} samples out; streamed "
            f"vs one-shot: analysis max|err| {aerr[0]:.3g} (/scale {aerr[1]:.3g}), inversion "
            f"{ierr[0]:.3g} (/scale {ierr[1]:.3g}) (tol {STREAM_TOL})")
        log("stream", f"{name}: chain per block of 2 x {STREAM_BLOCK}: "
            + ", ".join(f"{t:.3f}" for t in ms) + " ms; "
            + ", ".join(f"{2 * min(STREAM_BLOCK, n_dat - i * STREAM_BLOCK) / (t * 1e3):.1f}"
                        for i, t in enumerate(ms))
            + f" Msamples/s; total {sum(ms):.3f} ms = {x.numel() / (sum(ms) * 1e3):.1f} "
            f"Msamples/s, one-shot module {one_shot_ms[name]:.3f} ms; host time to issue "
            "each block " + ", ".join(f"{t:.3f}" for t in host) + f" ms; device busy "
            f"{busy:.3f} ms of the pass (torch.profiler; largest: {top}) ({smi})")
        del x, chan, out, one, inv_one


def cascade(torch, fb, inv, blocks, testers=()):
    """One pass of a two-stage cascade from fresh states, block by block:
    ``fb`` (TwoStageFilterBank) then ``inv`` (TwoStageInverseFilterBank).
    Returns the joined inverse output, the chain's ms (CUDA events) and
    each tester's (state, results)."""
    fs, ist = fb.init_state(), inv.init_state()
    outs = []
    start, end = events(torch)
    start.record()
    for xb in blocks:
        fs, y = fb.execute(fs, xb)
        ist, z = inv.execute(ist, y)
        outs.append(z)
    end.record()
    torch.cuda.synchronize()
    judged = []
    for t in testers:
        state, results = t.init_state(), []
        for z in outs:
            if z.shape[-1]:
                state, r = t.test(state, z)
                results.append(r)
        judged.append((state, results))
    return torch.cat(outs, 2), start.elapsed_time(end), judged


def cascade_blocks(torch, gen):
    """CASCADE_BLOCKS blocks of a generator's samples, both polarizations
    alike: (2, n) each."""
    bs = CASCADE_N_DAT // CASCADE_BLOCKS
    return [gen.generate(i * bs, bs)[:, 0].repeat(2, 1) for i in range(CASCADE_BLOCKS)]


def cascade_testers(cfg1, cfg2, impulse=False):
    """TestPureTone (or TestImpulse) as cli/sgcht.py:276-471 builds it for
    ``--two_stage --invert``: the tested stream is stage 1's coarse
    channels after the stage-2 round trip."""
    from fractions import Fraction

    from ska_pst_dsp_tpu_torch.models import TestImpulse, TestPureTone
    from ska_pst_dsp_tpu_torch.ops import lowcbf
    from ska_pst_dsp_tpu_torch.utils import geometry

    filt1, filt2 = cfg1.load_fir_filter_coeff(), cfg2.load_fir_filter_coeff()
    os1, n1 = cfg1.os_factor, cfg1.channels
    step1 = geometry.analysis_step(n1, os1)
    lc2 = cfg2.analysis_function == "polyphase_analysis_lowcbf"
    if impulse:
        fl1 = geometry.padded_filter_length(filt1.size, n1)
        t1 = (IMPULSE_AT - fl1 / 2) / step1 - geometry.total_sample_shift(
            cfg2.channels, cfg2.os_factor, filt2.size, cfg2.input_overlap)
        filter_offset = os1.normalize(cfg1.input_overlap) * n1 - 1 + cfg1.kludge_offset
        return TestImpulse(offset=IMPULSE_AT + cfg1.fir_offset_direction * (filt1.size // 2)
                           - filter_offset, chan_peak_col=int(math.floor(t1 + 0.5)),
                           chan_support=fl1 // step1 + 2)
    fl2 = lowcbf.NFILT + lowcbf.FIRST_CALL_PAD if lc2 else filt2.size
    resample = None
    if lc2:  # the stage-2 LowCBF round trip keeps its 216-channel sub-band
        resample = (Fraction(cfg2.channels, lowcbf.KEPT),
                    Fraction(cfg2.channels // 2 - lowcbf.KEPT_LO, lowcbf.KEPT))
    return TestPureTone(frequency=TONE, stages=[(n1, os1)], resample=resample,
                        lowcbf_stages=(False,), skip=-(-filt1.size // step1) + 2 + 2 * fl2)


def run_case(torch, dev, smi, phase, cfg1, cfg2, label, fwd, inv_kw, kernels, composed,
             blocks, testers=()):
    """One cascade on the kernels (plain versions patched to raise; the
    plain epilogue and torch.fft stay where ``composed``), its launches,
    its testers and its match with the same chain on the plain versions."""
    from ska_pst_dsp_tpu_torch.models import TwoStageFilterBank, TwoStageInverseFilterBank

    def modules(plain):
        return (TwoStageFilterBank(cfg1, cfg2, device=dev, plain=plain, **fwd),
                TwoStageInverseFilterBank(cfg1, cfg2, device=dev, plain=plain, **inv_kw))

    kern = modules(False)
    cascade(torch, *kern, blocks)  # the first pass builds the constants and plans
    ws = reset_counts()
    with plain_versions_raise(torch, composed=composed):
        out, ms, judged = cascade(torch, *kern, blocks, testers=testers)
    counts = read_counts(torch, ws)
    expect_launches(f"{phase} {label}", counts, kernels, composed)
    busy, top, _ = breakdown(torch, lambda: cascade(torch, *kern, blocks))
    ref, plain_ms, _ = cascade(torch, *modules(True), blocks)
    err = rel_err(out, ref)
    check(out.shape[2] > 0 and err[1] <= CASCADE_TOL,
          f"{phase} {label}: {tuple(out.shape)}, vs plain {err[1]:.3g}")
    n = sum(b.numel() for b in blocks)
    log(phase, f"{label}: out {tuple(out.shape)}; launches {counts}; vs plain chain max|err| "
        f"{err[0]:.3g}, /scale {err[1]:.3g} (tol {CASCADE_TOL}); kernels {ms:.3f} ms = "
        f"{n / (ms * 1e3):.1f} Msamples/s, plain {plain_ms:.3f} ms; device busy {busy:.3f} ms "
        f"(torch.profiler; largest: {top}) ({smi})")
    for t, (state, results) in zip(testers, judged):
        seen = (state.judged > 0 if hasattr(t, "skip")
                else 0 <= t.chan_peak_col < state.current)
        check(seen, f"{phase} {label}: {type(t).__name__} judged nothing")
        check(all(r == 0 for r in results),
              f"{phase} {label}: {type(t).__name__} failed: {state.detail}")
        log(phase, f"{label}: {type(t).__name__} passed on {len(results)} blocks "
            f"(db_max {t.db_max} dB)")
    return out


def measure(torch, phase, name, kern, plain, bnd, lib, match, smi):
    """A kernel at a cascade's geometry: its time, its plain version's, its
    device time, its bound and its library call's (None where there is
    none), logged with the card."""
    err = rel_err(kern(), plain())
    ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain)
    lib_ms = None if lib is None else time_ms(torch, lib)
    dev_ms = device_ms(torch, kern, match)
    log(phase, f"{name}: max|err|/scale {err[1]:.3g}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, device " + (", ".join(f"{k} {v:.4f}" for k, v in dev_ms.items())
                                         or "not measured")
        + f" ms, bound {bnd[0]:.4f} ms ({bnd[1]}), library "
        + ("none" if lib_ms is None else f"{lib_ms:.4f} ms") + f" ({smi})")
    return err


def cascade_kernel_times(torch, dev, smi):
    """The kernels at the cascades' geometries, each against its plain
    version: the analysis at sps (25 x 256 at hop 216), LowCBF (12 x 256,
    the quarter-turn table) and low stage 2 over 512 streams; the corner
    turn; the frontend at 256, 192, 216 and 3072 channels; the pair at
    1536 x 384 (589824 points); the composed epilogues."""
    from ska_pst_dsp_tpu_torch.ops import lowcbf
    from ska_pst_dsp_tpu_torch.ops import synthesis as ps
    from ska_pst_dsp_tpu_torch.ops.analysis import _prep_filter, analysis_core, ramp_table
    from ska_pst_dsp_tpu_torch.ops.framing import frame
    from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import analysis_fused
    from ska_pst_dsp_tpu_torch.ops.kernels.ifft_big import fused_big_ifft_oc
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import epilogue_plan, synthesis_fused
    from ska_pst_dsp_tpu_torch.utils import geometry
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    phase = "cascade-kernels"
    bs = CASCADE_N_DAT // CASCADE_BLOCKS
    low, sps, lowpsi = (load_config(n) for n in ("low", "sps", "lowpsi"))
    # stage 1's spectra of one block (whole chunks of nu): stage 2's streams
    t_low, t_sps = (bs - 3328) // 192 // 3 * 3, (bs - 6400) // 216 // 32 * 32
    analyses = (
        ("analysis_fused sps stage 1 (2 streams)", (2, bs), _prep_filter(
            sps.load_fir_filter_coeff(), 256), ramp_table(256, 216), 216),
        ("analysis_fused low stage 2 (512 streams)", (512, t_low), _prep_filter(
            low.load_fir_filter_coeff(), 256), ramp_table(256, 192), 192),
        ("analysis_fused LowCBF stage 2 (512 streams, first call)",
         (512, t_sps + lowcbf.FIRST_CALL_PAD),
         lowcbf.lowcbf_filter(lowpsi.load_fir_filter_coeff()), lowcbf.lowcbf_ramp(), 192),
    )
    for name, shape, f2d, ramp, step in analyses:
        x = torch.as_tensor(noise(shape, SEED + shape[1]), device=dev)
        f2d, ramp = torch.as_tensor(f2d, device=dev), torch.as_tensor(ramp, device=dev)
        out = analysis_core(x, f2d, ramp, step)
        n_spec, phases = out.shape[0] * out.shape[1], f2d.shape[0]
        err = measure(torch, phase, name, lambda: analysis_fused(x, f2d, ramp, step),
                      lambda: analysis_core(x, f2d, ramp, step),
                      bound(nbytes(x, f2d, ramp, out),
                            n_spec * 256 * (4 * phases + 6) + fft_flops(256, n_spec)), None,
                      "analysis_fused_kernel", smi)
        check(err[1] <= ANALYSIS_TOL, f"{name}: {err[1]:.3g}")
        del x, out
    # the corner turn of one block's stage-1 spectra, time-major, to 512 streams
    y = torch.as_tensor(noise((2, t_low, 256), SEED), device=dev).transpose(1, 2)
    ct = time_ms(torch, lambda: y.reshape(512, t_low))
    log(phase, f"corner turn (2, {t_low}, 256) -> (512, {t_low}): {ct:.4f} ms, "
        f"{2 * nbytes(y) / (ct * 1e6):.1f} GB/s read + written ({smi})")
    del y
    os_f = low.os_factor
    for n_chan, kw in ((256, {}), (192, {"spans_nyquist": False}), (216, {"monotonic": True}),
                       (3072, {"spans_nyquist": False, "combine": 16})):
        g = geometry.SynthesisGeometry(n_chan, 256, 48, os_f)
        c = ps.synthesis_constants(n_chan, 256, os_f, 48, temporal_taper="tukey",
                                   deripple_coeff=low.load_fir_filter_coeff(), **kw)
        n_slab = 32 if n_chan == 3072 else 512  # the cascades' slabs
        t_len = 2 * 48 + 4 * g.input_keep
        x_tc = torch.as_tensor(noise((n_slab, n_chan, t_len), SEED + n_chan),
                               device=dev).transpose(1, 2)
        args = [torch.as_tensor(c[k], device=dev) for k in ("t_taper", "dr", "perm")]
        fargs = (x_tc, *args, 256, g.input_keep, (128 + g.discard) % 256, 4)
        fn = ps.frontend(*fargs)
        frames = (frame(x_tc.index_select(-1, args[2]).transpose(1, 2), 256, g.input_keep, 4)
                  .transpose(1, 2) * args[0]).contiguous()
        n_frames = frames.shape[0] * frames.shape[1] * frames.shape[2]
        err = measure(torch, phase, f"synthesis_fused at {n_chan} channels ({n_slab} slabs)",
                      lambda: synthesis_fused(*fargs), lambda: ps.frontend(*fargs),
                      bound(nbytes(x_tc, *args, fn), fft_flops(256, n_frames) + 512 * n_frames),
                      lambda: torch.fft.fft(frames, dim=-1), "synthesis_frontend_kernel", smi)
        check(err[1] <= SYNTHESIS_TOL, f"frontend at {n_chan}: {err[1]:.3g}")
        n, lo = g.output_fft_length, g.output_overlap
        flat = fn.reshape(n_slab, 4, n)
        roll = g.fn_width // 2 if kw.get("spans_nyquist", True) else 0
        if n_chan == 3072:
            n2, n1 = epilogue_plan(n, lo)[1:]
            key = (n, 1, n2, n1, lo, roll, 0.75)
            err = measure(torch, phase, f"ifft_big pair at {n2} x {n1} ({n} points, "
                          f"{n_slab} x 4 blocks)",
                          lambda: fused_big_ifft_oc(flat, None, shape_key=key),
                          lambda: ps.epilogue(flat, None, lo, roll, 0.75, 4),
                          bound(nbytes(flat) + n_slab * 4 * (n - 2 * lo) * 8,
                                fft_flops(n, n_slab * 4)),
                          lambda: torch.fft.ifft(flat, dim=-1), "ifft_big", smi)
            check(err[1] <= BIG_IFFT_TOL, f"pair at {n}: {err[1]:.3g}")
        elif n_chan in (192, 216):
            ms = time_ms(torch, lambda: ps.epilogue(flat, None, lo, roll, 0.75, 4))
            log(phase, f"composed epilogue at {n} points ({n_slab} x 4 blocks): {ms:.4f} ms "
                f"({smi})")
        del x_tc, fn, frames, flat


def run_two_stage(torch, dev, smi):
    """Phase 10: the low two-stage cascade (256 x 256 fine channels a
    polarization), 2 pol x 2^25 samples in 4 blocks, for the sweep's
    inverted cases (cli/test_sgcht.py:22-32): oversampled (cluster
    epilogue), critical (composed epilogue) and critical with combine 16
    (the ifft_big pair at 589824 points); the oversampled case's tone and
    impulse pass TestPureTone and TestImpulse at -60 dB."""
    from ska_pst_dsp_tpu_torch.models import Impulse, PureTone
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    low = load_config("low")
    tone = cascade_blocks(torch, PureTone(TONE, device=dev))
    cases = (
        ("oversampled", {}, {"nch2": 256}, LOW_KERNELS, False),
        ("critical", {"critical": True}, {"nch2": 192}, ("analysis_fused", "synthesis_fused"),
         True),
        ("critical, combine 16", {"critical": True}, {"nch2": 192, "combine": 16},
         ("analysis_fused", "synthesis_fused", "ifft_big_inner", "ifft_big_outer"), False),
    )
    for label, fwd, inv_kw, kernels, composed in cases:
        testers = (cascade_testers(low, low),) if label == "oversampled" else ()
        run_case(torch, dev, smi, "two-stage", low, low, f"{label}, tone", fwd, inv_kw,
                 kernels, composed, tone, testers)
    del tone
    impulse = cascade_blocks(torch, Impulse(offset=IMPULSE_AT, device=dev))
    run_case(torch, dev, smi, "two-stage", low, low, "oversampled, impulse", {}, {"nch2": 256},
             cases[0][3], False, impulse, (cascade_testers(low, low, impulse=True),))
    del impulse
    cascade_kernel_times(torch, dev, smi)


def run_sps_lowpsi(torch, dev, smi):
    """Phase 11: the SKA-Low PST chain, sps (256 ch, OS 32/27) then the
    LowCBF firmware filterbank (lowpsi: 216 of 256 channels kept) over 512
    streams, and the oversampled monotonic inversion of the 216-channel
    slabs (the fused inversion: 41472 points have no epilogue plan), 2 pol x 2^25
    samples in 4 blocks; the tone passes TestPureTone at -60 dB. Then the
    LowCBF route on the card against the port's fp64 oracle: 2 pol x 2^23
    noise on the first call, a 2^20 prefix on a later call, and 8 of the
    512 streams the first block's stage 1 feeds to LowCBF (each held to its
    peak over all 256 channels)."""
    from ska_pst_dsp_tpu_torch.models import PureTone, TwoStageFilterBank
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    sps, lowpsi = load_config("sps"), load_config("lowpsi")
    tone = cascade_blocks(torch, PureTone(TONE, device=dev))
    run_case(torch, dev, smi, "sps-lowpsi", sps, lowpsi, "oversampled, tone", {},
             {"nch2": lowpsi.kept_channels}, LOW_KERNELS, False, tone,
             (cascade_testers(sps, lowpsi),))
    filt = lowpsi.load_fir_filter_coeff()
    x = torch.as_tensor(noise((2, N_DAT), SEED + 11), device=dev)
    lowcbf_vs_oracle(torch, smi, lowpsi, filt, x, True, "2 pol x 2^23 noise, first call")
    lowcbf_vs_oracle(torch, smi, lowpsi, filt, x[:, :LOWCBF_PREFIX].contiguous(), False,
                     "2 pol x 2^20 noise prefix, later call")
    del x
    stage1 = TwoStageFilterBank(sps, lowpsi, device=dev).stage1
    _, out1 = stage1.execute(stage1.init_state(), tone[0])
    streams = out1.reshape(-1, out1.shape[2])  # the corner turn: 512 streams
    pick = np.sort(np.random.default_rng(SEED).choice(streams.shape[0], LOWCBF_STREAMS,
                                                      replace=False))
    lowcbf_vs_oracle(torch, smi, lowpsi, filt,
                     streams[torch.as_tensor(pick, device=dev)].contiguous(), True,
                     f"sps stage-1 streams {pick.tolist()} of the first block, first call",
                     band_scale=True)


def torch_noise(torch, shape, seed, dev):
    """Complex64 noise made on the card (the cell's sizes, in seconds)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.complex(torch.randn(shape, generator=g, device=dev),
                         torch.randn(shape, generator=g, device=dev))


def time_major_cascade(torch, cfg1, cfg2, dev):
    """The cascade over time-major stages: each stage's output a view of the
    analysis's time-major store (LowCBF's kept bins gathered), so that the
    cascade's corner turns copy, as they did before the channel-major
    store."""
    from ska_pst_dsp_tpu_torch.models import TwoStageFilterBank, streaming

    fb = TwoStageFilterBank(cfg1, cfg2, device=dev)
    fb.stage1 = streaming.FilterBank(cfg1, device=dev)
    fb.stage2 = streaming.FilterBank(cfg2, device=dev)
    return fb


def run_channel_major(torch, dev, smi):
    """Phase 11b: the analysis's channel-major store, which SKA-Low's PST
    cascade runs. At the lowpsi.cascade cell's shapes (sps over 2 x (2^26 +
    a carry), LowCBF over the 512 streams of its spectra on the first call):
    bitwise the time-major store with torch's index_select and transpose,
    timed beside the time-major kernel, beside the torch copies it replaces
    and beside the plain version (at 1/16 of the shape). Then two blocks of
    2 x 2^26 through the cascade and the same cascade over time-major
    stages: outputs, states and the inverse's outputs bitwise, two
    channel-major launches a block, no corner-turn bytes. Returns the
    kernels-line entry."""
    from ska_pst_dsp_tpu_torch.models import TwoStageFilterBank, TwoStageInverseFilterBank
    from ska_pst_dsp_tpu_torch.ops import lowcbf
    from ska_pst_dsp_tpu_torch.ops.analysis import analysis_plain
    from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import analysis_fused
    from ska_pst_dsp_tpu_torch.utils import profiling
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    phase = "channel-major"
    sps, lowpsi = load_config("sps"), load_config("lowpsi")
    fb = TwoStageFilterBank(sps, lowpsi, device=dev)
    st1, st2 = fb.stage1, fb.stage2
    check(st1.channel_major and st2.channel_major, f"{phase}: both stages channel-major")
    t1 = (CELL_BLOCK + SPS_CARRY - st1.fl) // st1.step // 32 * 32
    entry = {"name": "analysis_fused channel-major", "route": "cuda",
             "source": "ska_pst_dsp_tpu_torch/csrc/analysis_fused.cu",
             "replaces": "the time-major store + the cascade's corner turns and kept-bin "
                         "gather (torch copies)"}
    for name, st, shape, step in (("sps", st1, (2, st1.fl + t1 * st1.step), st1.step),
                                  ("lowcbf", st2, (512, t1 + lowcbf.FIRST_CALL_PAD),
                                   lowcbf.STEP)):
        x = torch_noise(torch, shape, SEED + shape[0], dev)
        bins = st.rows.long()

        def cm(x=x, st=st, step=step):
            return analysis_fused(x, st.f2d, st.ramp, step, 0, rows=st.rows)

        def tm(x=x, st=st, step=step):
            return analysis_fused(x, st.f2d, st.ramp, step, 0)

        def library(bins=bins, tm=tm):
            out = tm()
            return (out if bins.numel() == out.shape[2] else out.index_select(-1, bins)
                    ).transpose(1, 2).contiguous()

        n0 = analysis_fused.launches, analysis_fused.channel_major_launches
        got = cm()
        check((analysis_fused.launches - n0[0], analysis_fused.channel_major_launches - n0[1])
              == (1, 1), f"{phase} {name}: one launch, counted channel-major")
        same = bool(torch.equal(got, library()))
        check(same and got.is_contiguous(),
              f"{phase} {name}: channel-major store {tuple(got.shape)} not bitwise the "
              "time-major store's bins, transposed")
        cut = x[: max(1, shape[0] // 16)] if shape[0] > 2 else x[:, :st.fl + t1 // 16 * step]
        plain_ms = time_ms(torch, lambda: analysis_plain(cut, st.f2d, st.ramp, step, 0,
                                                         rows=st.rows), reps=3)
        n_spec, phases = shape[0] * got.shape[2], st.f2d.shape[0]
        bnd = bound(nbytes(x, st.f2d, st.ramp, got),
                    n_spec * 256 * (4 * phases + 6) + fft_flops(256, n_spec))
        row = {"shape_in": list(shape), "shape_out": list(got.shape), "bitwise": same,
               "ms": time_ms(torch, cm), "time_major_ms": time_ms(torch, tm),
               "library_ms": time_ms(torch, library),
               "device_ms": device_ms(torch, cm, "analysis_fused_kernel"),
               "time_major_device_ms": device_ms(torch, tm, "analysis_fused_kernel"),
               "library_device_ms": device_ms(torch, library, ""),
               "plain_ms_at_1_16": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
        entry[name] = row
        log(phase, f"{name} {tuple(shape)} -> {tuple(got.shape)}: bitwise {same}; "
            f"channel-major {row['ms']:.4f} ms (device {row['device_ms']}), time-major "
            f"{row['time_major_ms']:.4f} ms, time-major + torch copies {row['library_ms']:.4f} "
            f"ms (device {row['library_device_ms']}), plain at 1/16 {plain_ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}) ({smi})")
        del x, got, cut
    entry["resources"] = RESOURCES.get("analysis_fused", {})

    # two blocks through the cascade and through time-major stages, in turns
    x = torch_noise(torch, (2, 2 * CELL_BLOCK), SEED + 3, dev)
    inv = TwoStageInverseFilterBank(sps, lowpsi, nch2=lowpsi.kept_channels, device=dev)
    old, old_inv = (time_major_cascade(torch, sps, lowpsi, dev),
                    TwoStageInverseFilterBank(sps, lowpsi, nch2=lowpsi.kept_channels,
                                              device=dev))
    states = {"new": [fb.init_state(), inv.init_state()],
              "old": [old.init_state(), old_inv.init_state()]}
    for b in range(2):
        xb = x[:, b * CELL_BLOCK:(b + 1) * CELL_BLOCK]
        outs, grew = {}, {}
        for side, (f, i) in (("new", (fb, inv)), ("old", (old, old_inv))):
            before = profiling.counters()
            s = states[side]
            s[0], y = f.execute(s[0], xb)
            s[1], z = i.execute(s[1], y)
            torch.cuda.synchronize()
            after = profiling.counters()
            grew[side] = {k: after[k] - before[k] for k in
                          ("analysis_fused_channel_major", "corner_turn_bytes")}
            outs[side] = (y, z)
        (yn, zn), (yo, zo) = outs["new"], outs["old"]
        sn, so = states["new"][0], states["old"][0]
        same = (torch.equal(yn, yo) and torch.equal(zn, zo) and all(
            (a.base, a.emitted) == (c.base, c.emitted) and torch.equal(a.buffer, c.buffer)
            for a, c in ((sn.stage1, so.stage1), (sn.stage2, so.stage2))))
        check(same, f"{phase}: block {b} of the cascade not bitwise the time-major stages'")
        check(grew["new"] == {"analysis_fused_channel_major": 2, "corner_turn_bytes": 0},
              f"{phase}: block {b} counted {grew['new']}")
        check(grew["old"]["analysis_fused_channel_major"] == 0
              and grew["old"]["corner_turn_bytes"] > 0, f"{phase}: time-major {grew['old']}")
        log(phase, f"cascade block {b} (2 x {CELL_BLOCK}): output {tuple(yn.shape)}, inverse "
            f"{tuple(zn.shape)}, states bitwise the time-major stages'; counters "
            f"{grew['new']}, time-major stages {grew['old']}")
        del outs, yn, zn, yo, zo
    return entry


def lowcbf_band_peaks(x64, filt, first_call):
    """(n,) peak |spectrum| of each of the streams x64 over all 256 LowCBF
    channels, before the 216 are kept, in fp64 at the oracle's scale (fold
    / 2^9, FFT / 128, * 2^9 * 2048 * 256)."""
    xp = np.concatenate([np.zeros((x64.shape[0], 1536 if first_call else 0)), x64], axis=1)
    n_out = (xp.shape[1] - 3072) // 192
    frames = np.lib.stride_tricks.sliding_window_view(xp, 3072, axis=1)[:, ::192][:, :n_out]
    fold = (frames.reshape(*frames.shape[:2], 12, 256) * filt.reshape(12, 256)).sum(2)
    return np.abs(np.fft.fft(fold, axis=-1)).max(axis=(1, 2)) * (2048 * 256 / 128)


def lowcbf_vs_oracle(torch, smi, cfg, filt, x, first_call, label, band_scale=False):
    """One call of ops.lowcbf.polyphase_analysis_lowcbf on the (n, n_dat)
    complex64 streams x on the card, with the plain versions and torch.fft
    patched to raise, held over all its spectra to the port's fp64 oracle
    on the same samples; the analysis kernel launched exactly once. The
    error is taken over the peak of the kept channels or, with
    ``band_scale``, over each stream's peak across all 256 channels: fp32
    rounding follows a stream's whole power, and real streams hold some of
    theirs in the edge channels LowCBF discards."""
    from ska_pst_dsp_tpu_torch import oracle
    from ska_pst_dsp_tpu_torch.ops import lowcbf
    from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import analysis_fused

    def call():
        return lowcbf.polyphase_analysis_lowcbf(x, filt, first_call=first_call)

    analysis_fused.launches = 0
    with plain_versions_raise(torch):
        got = call()
        torch.cuda.synchronize()
    launches = analysis_fused.launches
    check(launches == 1, f"sps-lowpsi LowCBF {label}: {launches} analysis_fused launches")
    x64 = x.cpu().numpy().astype(np.complex128)
    t0 = time.perf_counter()
    ref = oracle.polyphase_analysis_lowcbf(x64[:, None], filt, cfg.channels, cfg.os_factor,
                                           first_call)
    oracle_s = time.perf_counter() - t0
    got = got.cpu().numpy()
    check(got.shape == ref.shape and ref.shape[2] > 0,
          f"sps-lowpsi LowCBF {label}: shape {got.shape}, oracle {ref.shape}")
    err = np.abs(got - ref)
    kept = float(err.max() / np.abs(ref).max())
    if band_scale:
        rel = float((err.max(axis=(1, 2)) / lowcbf_band_peaks(x64, filt, first_call)).max())
        what = f"/peak {kept:.3g}, /each stream's 256-channel peak {rel:.3g}"
    else:
        rel, what = kept, f"/peak {kept:.3g}"
    check(rel <= LOWCBF_ORACLE_TOL, f"sps-lowpsi LowCBF {label}: {what}")
    with plain_versions_raise(torch):
        ms = time_ms(torch, call)
    log("sps-lowpsi", f"LowCBF on the card vs the fp64 oracle, {label}: out {got.shape}, "
        f"every spectrum; analysis_fused launches {launches}; max|err| {err.max():.3g}, "
        f"{what} (tol {LOWCBF_ORACLE_TOL} on the last); card {ms:.4f} ms, oracle "
        f"{oracle_s:.2f} s ({smi})")


def run_dedispersion(torch, dev, smi):
    """Phase 12: a dispersed square wave through the analysis and the
    inversion with the dedispersion chirp as its spectral filter: on the
    cluster epilogue's ``elem`` (low, 2 pol x 2^23) and on the ifft_big
    pair's complex ``elem`` (mid, 2 pol x 4,587,520), each within 1.2e-5 /
    1e-4 * scale of the plain inversion with the same filter; the
    block-wise against the whole-stream dedispersion in dB, as
    tools/dedispersion_tpu.py records it."""
    from ska_pst_dsp_tpu_torch.models import SquareWave
    from ska_pst_dsp_tpu_torch.ops import dedispersion as dd
    from ska_pst_dsp_tpu_torch.ops import synthesis as ps
    from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import polyphase_analysis_fused
    from ska_pst_dsp_tpu_torch.ops.kernels.analysis_padded_fused import (
        polyphase_analysis_padded_fused,
    )
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import (
        fused_inversion, polyphase_synthesis_fused,
    )
    from ska_pst_dsp_tpu_torch.utils import geometry
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    for name, n_dat, dm in (("low", N_DAT, DM_LOW), ("mid", MID_N_DAT, DM_MID)):
        cfg = load_config(name)
        filt = cfg.load_fir_filter_coeff()
        g = geometry.SynthesisGeometry(cfg.channels, cfg.input_fft_length, cfg.input_overlap,
                                       cfg.os_factor)
        delay = dd.dispersion_delay(dm, F0_MHZ - BW_MHZ / 2, F0_MHZ + BW_MHZ / 2) * BW_MHZ * 1e6
        check(delay < g.output_overlap, f"dedisp-{name}: delay {delay:.0f} samples")
        clean = torch.cat([SquareWave(period=4096, duty_cycle=0.1, on_amp=4.0, off_amp=0.04,
                                      seed=11 + p, device=dev).generate(0, n_dat)[:, 0]
                           for p in range(2)])
        x = dd.dedisperse(clean, dm, F0_MHZ, BW_MHZ, inverse=True)
        analysis = (polyphase_analysis_fused if name == "low"
                    else polyphase_analysis_padded_fused)
        chan = analysis(x, filt, cfg.channels, cfg.os_factor, time_major=True)
        h = dd.chirp_filter(cfg.channels * g.fn_width, dm, F0_MHZ, BW_MHZ)
        kw = dict(input_overlap=cfg.input_overlap, temporal_taper=cfg.temporal_taper,
                  deripple_coeff=filt if cfg.deripple else None)
        inv = lambda sf: polyphase_synthesis_fused(  # noqa: E731
            chan, cfg.input_fft_length, cfg.os_factor, time_major_in=True, spectral_filter=sf,
            **kw)
        inv(h)
        ws = reset_counts()
        with plain_versions_raise(torch):
            b = inv(h)
        counts = read_counts(torch, ws)
        kernels = (("inversion_fused",) if name == "low"
                   else ("synthesis_fused", "ifft_big_inner", "ifft_big_outer"))
        expect_launches(f"dedisp-{name}", counts, kernels, composed=False)
        c = ps.polyphase_synthesis(chan.transpose(1, 2), cfg.input_fft_length, cfg.os_factor,
                                   spectral_filter=h, **kw)
        err = rel_err(b, c)
        check(err[1] <= DEDISP_TOL[name], f"dedisp-{name}: {err[1]:.3g}")
        a = dd.dedisperse(inv(None), dm, F0_MHZ, BW_MHZ)
        guard = a.shape[2] // 8
        diff = (b - a)[..., guard:-guard].abs() ** 2
        ref = a[..., guard:-guard].abs() ** 2
        # the inversion with its constants built once, as a module holds them
        c = ps.synthesis_constants(cfg.channels, cfg.input_fft_length, cfg.os_factor,
                                   spectral_filter=h, **kw)
        consts = [torch.as_tensor(c[k], device=dev) for k in ("t_taper", "dr", "perm", "elem")]
        ms = time_ms(torch, lambda: fused_inversion(chan, *consts, g, spans_nyquist=True))
        log("dedisp", f"{name}: dm {dm}, {F0_MHZ} MHz, {BW_MHZ} MHz: band delay {delay:.0f} "
            f"samples < output overlap {g.output_overlap}; launches {counts}; vs plain "
            f"inversion max|err| {err[0]:.3g}, /scale {err[1]:.3g} (tol {DEDISP_TOL[name]}); "
            f"block-wise vs whole-stream dedispersion: mean "
            f"{10 * math.log10(float(diff.mean() / ref.mean())):.2f} dB, max "
            f"{10 * math.log10(float(diff.max() / ref.max())):.2f} dB; inversion with the "
            f"chirp {ms:.3f} ms, its constants built once ({smi})")
        del clean, x, chan, a, b, c


def run_pst_node(torch, dev, smi):
    """Phase 12b: an SKA-Low PST node dedispersing J0437-4715 (DM 2.64476,
    coarse channels from 150.0 MHz, 0.78125 MHz apart): the fused inversion
    with its (256, 41472) chirp table at the node's geometry (216 monotonic
    channels, each frame discarding the taper's 48 and the chirp's reach,
    64 a side, hop 128) at the request's shapes, 512 slabs of 11 and of 22
    blocks through the transposed view, against its plain version within
    SYNTHESIS_TOL; the same launch on the stream's held samples and its new
    block as two inputs (``held``), with the seam inside a frame (the
    node's: 192 and 1344 held) and on a hop, bitwise the one-input launch
    and within SYNTHESIS_TOL of plain, timed beside the one-input launch
    and beside the launch on the two joined with ``torch.cat`` (the copy
    included, as the stage ran it before it read two inputs); then the node
    itself, ``TwoStageInverseFilterBank(lowpsi, nch2=216,
    dedispersion=...)``, over the benchmark cell's cycle of requests of
    1,600 samples, its state carried (seven of 11 blocks, holding 0 to
    1,152 samples, then one of 22 holding 1,344): one inversion_fused
    launch a request and no composed epilogue (no plain version, no
    torch.fft), a launch on two inputs a request after the first, nothing
    joined, each request's output against the node's plain chain carried
    over the same requests on the card."""
    from ska_pst_dsp_tpu_torch.models.two_stage import TwoStageInverseFilterBank
    from ska_pst_dsp_tpu_torch.ops import synthesis as ps
    from ska_pst_dsp_tpu_torch.ops.dedispersion import Dedispersion
    from ska_pst_dsp_tpu_torch.ops.kernels import inversion_fused as inv
    from ska_pst_dsp_tpu_torch.utils import profiling
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    cfg = load_config("lowpsi")
    band = Dedispersion(2.64476, 150.0, 0.78125)
    node = TwoStageInverseFilterBank(cfg, nch2=216, device=dev, dedispersion=band)
    state = node.init_state()
    g = node._geom
    n_chan, L, os_f = 216, cfg.input_fft_length, cfg.os_factor
    check(g.input_overlap == 64, f"pst-node: overlap {g.input_overlap}, expected 64")
    c = ps.synthesis_constants(n_chan, L, os_f, g.input_overlap,
                               deripple_coeff=cfg.load_fir_filter_coeff(),
                               temporal_taper="tukey", monotonic=True,
                               spectral_filter=band.table(g.output_fft_length, 256, centred=True),
                               taper_overlap=cfg.input_overlap)
    consts = [torch.as_tensor(c[k], device=dev) for k in ("t_taper", "dr", "perm", "elem")]
    keep, kpos = g.input_keep, (L // 2 + g.discard) % L
    n, lo, roll, gain = g.output_fft_length, g.output_overlap, g.fn_width // 2, os_f.de / os_f.nu
    check(inv.takes(L, n_chan, n, lo), "inversion_fused does not take the node's geometry")
    gen = torch.Generator(device=dev)
    for nb, node_h in ((11, 192), (22, 1344)):
        n_dat = 2 * g.input_overlap + nb * keep
        gen.manual_seed(SEED + 23 + nb)
        x = torch.randn((512, n_chan, n_dat + 64), dtype=torch.complex64, device=dev,
                        generator=gen)[:, :, :n_dat].transpose(1, 2)

        def fused(x=x, held=None):
            return inv.inversion_fused(x, *consts, keep, kpos, nb, lo, roll, gain, held=held)

        def plain():
            fn = ps.frontend(x, *consts[:3], L, keep, kpos, nb)
            return ps.epilogue(fn.reshape(512, nb, n), consts[3], lo, roll, gain, nb)

        want, ref = fused(), plain()
        err = rel_err(want, ref)
        check(err[1] <= SYNTHESIS_TOL, f"pst-node: the chirp table, {nb} blocks: {err[1]:.3g}")
        dms = device_ms(torch, fused, "inversion_fused_kernel")
        one_ms = time_ms(torch, fused)
        log("pst-node", f"inversion_fused with the (256, {n}) chirp table, 512 x {nb} blocks "
            f"(discard {lo} a side): max|err|/scale {err[1]:.3g} (tol {SYNTHESIS_TOL}); "
            f"kernel {one_ms:.4f} ms, device "
            + (", ".join(f"{k} {v:.4f} ms" for k, v in dms.items()) or "not measured")
            + f" ({smi})")
        for where, h in (("inside a frame", node_h), ("on a hop", 5 * keep)):
            held, tail = x[:, :h], x[:, h:]
            count = inv.inversion_fused.split_launches
            got = fused(tail, held)
            check(inv.inversion_fused.split_launches == count + 1,
                  "pst-node: a launch on two inputs not counted")
            check(torch.equal(got, want),
                  f"pst-node: two inputs, seam {h} ({where}), {nb} blocks: not the one-input bits")
            serr = rel_err(got, ref)
            check(serr[1] <= SYNTHESIS_TOL,
                  f"pst-node: two inputs, seam {h}, {nb} blocks: {serr[1]:.3g}")
            held_cm, tail_cm = held.transpose(1, 2), tail.transpose(1, 2)

            def joined():
                return fused(torch.cat([held_cm, tail_cm], dim=2).transpose(1, 2))

            times = {k: time_ms(torch, f) for k, f in (
                ("one input", fused), ("two inputs", lambda: fused(tail, held)),
                ("joined", joined), ("one input again", fused))}
            log("pst-node", f"two inputs, seam {h} ({where}), 512 x {nb} blocks: bitwise the "
                f"one-input launch, max|err|/scale {serr[1]:.3g} against plain; ms "
                + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
                + f" (joined: torch.cat then the launch) ({smi})")
        del x, want, ref
        torch.cuda.empty_cache()

    # the node over the cell's cycle of requests, its state carried
    block, cycle = 1600, 8
    gen.manual_seed(SEED + 24)
    stream = torch.randn((2, 256 * n_chan, cycle * block), dtype=torch.complex64, device=dev,
                         generator=gen)
    plain_node = TwoStageInverseFilterBank(cfg, nch2=216, device=dev, plain=True,
                                           dedispersion=band)
    pstate = plain_node.init_state()
    ws = reset_counts()
    inv.inversion_fused.split_launches = 0
    seen, worst = [], 0.0
    for i in range(cycle):
        blk = stream[:, :, i * block:(i + 1) * block]
        h = 0 if state.stage2.buffer is None else state.stage2.buffer.shape[-1]
        before = profiling.counters()
        with plain_versions_raise(torch):
            state, out = node.execute(state, blk)
        counts = read_counts(torch, ws)
        after = profiling.counters()
        expect_launches(f"pst-node request {i}", counts, ("inversion_fused",), composed=False)
        got = {k: after[k] - before[k]
               for k in ("inversion_fused", "inversion_fused_split", "carry_bytes")}
        check(got == {"inversion_fused": 1, "inversion_fused_split": int(i > 0),
                      "carry_bytes": 0}, f"pst-node request {i} (held {h}): counted {got}")
        pstate, ref = plain_node.execute(pstate, blk)
        err = rel_err(out, ref)
        check(out.shape == ref.shape and out.shape[:2] == (2, 256),
              f"pst-node request {i}: {tuple(out.shape)} against {tuple(ref.shape)}")
        check(err[1] <= SYNTHESIS_TOL, f"pst-node request {i} (held {h}): {err[1]:.3g}")
        seen.append((h, out.shape[-1] // g.output_keep))
        worst = max(worst, err[1])
        del out, ref
    check(seen == [(192 * i, 11) for i in range(cycle - 1)] + [(1344, 22)],
          f"pst-node: (held, blocks) a request {seen}, not the cell's cycle")
    check(tuple(node._inv.elem.shape) == (256, n), f"pst-node: elem {tuple(node._inv.elem.shape)}")
    log("pst-node", f"TwoStageInverseFilterBank with dedispersion over {cycle} requests of "
        f"2 x 256 x 216 x {block}, its state carried: (held, blocks) a request {seen}; "
        f"inversion_fused {ws['inversion_fused'].launches} launches, "
        f"{inv.inversion_fused.split_launches} of them on two inputs, nothing joined; "
        f"against the plain chain carried alike max|err|/scale {worst:.3g} "
        f"(tol {SYNTHESIS_TOL}) ({smi})")
    del stream


#: PSR J1909-3744's DM, and the coarse channels' plan of the PST node cells
J1909_DM, FIRST_MHZ, COARSE_MHZ = 10.3919, 150.0, 0.78125


def pst1909_stage(length):
    """The lowpst1909 configuration's LowCBF stage at frame length
    ``length`` (512 as the cell has it; 256 as upstream's lowpsi), as the
    benchmark's kind builds it."""
    from pstbench import design, run, system

    cfg = run.load_json(run.HERE / "configs" / "lowpst1909.json")
    stage = system.PortConfig({**cfg, "input_fft_length": length}, design.prototype_filter(cfg))
    stage.kept_channels = cfg["kept_channels"]
    return stage


def run_pst_long(torch, dev, smi):
    """Phase 12c: the fused inversion's third plan, a LowCBF PST slab at
    L 512 (Psi512Plan: 216 channels, 82,944 = 216 * 384 points, 188 KiB of
    shared memory a block, one block an SM), at the lowpst1909.dedisp cell's
    shapes: 512 slabs (2 pol x 256 coarse channels) of 4 and 8 blocks
    through the transposed channel-major view, stream p reading row p % 256
    of the (256, 82,944) chirp table of PSR J1909-3744, each frame
    discarding 100 a side (the taper's 48 and the chirp's reach), against
    its plain version within SYNTHESIS_TOL, ms a call and device ms; the
    same launch on held samples and a new block (the seam inside a frame
    and on a hop) bitwise the one-input launch; the three plans' registers
    and spills from ptxas; then the J1909-3744 node,
    ``TwoStageInverseFilterBank(..., dedispersion=...)``, over 8 requests of
    the cell's 2 x 256 x 216 x 1,600 fine samples, its state carried, at
    L 512 and at the upstream L 256 (on PsiPlan, hop 56), each launching
    inversion_fused once a request and nothing else (on two inputs after the
    first request), each request's ms and
    the median ns an output sample side by side: the frame length's gain."""
    from ska_pst_dsp_tpu_torch.models.two_stage import TwoStageInverseFilterBank
    from ska_pst_dsp_tpu_torch.ops import synthesis as ps
    from ska_pst_dsp_tpu_torch.ops.dedispersion import Dedispersion
    from ska_pst_dsp_tpu_torch.ops.kernels import inversion_fused as inv

    band = Dedispersion(J1909_DM, FIRST_MHZ, COARSE_MHZ)
    stage = pst1909_stage(512)
    node = TwoStageInverseFilterBank(stage, nch2=216, device=dev, dedispersion=band)
    node.init_state()
    g = node._geom
    n_chan, L, os_f = 216, 512, node._inv.os_factor
    check((g.input_overlap, g.input_keep, g.output_fft_length, g.output_overlap)
          == (100, 312, 82944, 16200), f"pst-long: geometry {g}")
    check(inv.takes(L, n_chan, g.output_fft_length, g.output_overlap),
          "inversion_fused does not take the L 512 node's geometry")
    c = ps.synthesis_constants(n_chan, L, os_f, g.input_overlap,
                               deripple_coeff=stage.load_fir_filter_coeff(),
                               temporal_taper="tukey", monotonic=True,
                               spectral_filter=band.table(g.output_fft_length, 256, centred=True),
                               taper_overlap=stage.input_overlap)
    consts = [torch.as_tensor(c[k], device=dev) for k in ("t_taper", "dr", "perm", "elem")]
    keep, kpos = g.input_keep, (L // 2 + g.discard) % L
    n, lo, roll, gain = g.output_fft_length, g.output_overlap, g.fn_width // 2, os_f.de / os_f.nu
    clusters = inv.active_clusters(n_chan, L)
    log("pst-long", f"Psi512Plan: {clusters} clusters of 8 resident (PsiPlan "
        f"{inv.active_clusters(n_chan, 256)}, LowPlan {inv.active_clusters()})")
    plans = RESOURCES.get("inversion_fused", {})
    log("pst-long", "registers and spills: " + "; ".join(
        f"{k} {v['registers']} registers, {v['spill_stores']} / {v['spill_loads']} B "
        f"spilled" for k, v in sorted(plans.items())))
    gen = torch.Generator(device=dev)
    for nb in (4, 8):
        n_dat = 2 * g.input_overlap + nb * keep
        gen.manual_seed(SEED + 25 + nb)
        x = torch.randn((512, n_chan, n_dat + 64), dtype=torch.complex64, device=dev,
                        generator=gen)[:, :, :n_dat].transpose(1, 2)

        def fused(x=x, held=None):
            return inv.inversion_fused(x, *consts, keep, kpos, nb, lo, roll, gain, held=held)

        def plain():
            fn = ps.frontend(x, *consts[:3], L, keep, kpos, nb)
            return ps.epilogue(fn.reshape(512, nb, n), consts[3], lo, roll, gain, nb)

        want, ref = fused(), plain()
        err = rel_err(want, ref)
        check(err[1] <= SYNTHESIS_TOL, f"pst-long: 512 x {nb} blocks: {err[1]:.3g}")
        dms = device_ms(torch, fused, "inversion_fused_kernel")
        one_ms = time_ms(torch, fused)
        log("pst-long", f"inversion_fused at L 512 with the (256, {n}) chirp table, 512 x {nb} "
            f"blocks (discard {lo} a side): max|err|/scale {err[1]:.3g} (tol {SYNTHESIS_TOL}); "
            f"kernel {one_ms:.4f} ms a call, device "
            + (", ".join(f"{k} {v:.4f} ms" for k, v in dms.items()) or "not measured")
            + f" ({smi})")
        for where, h in (("inside a frame", 150), ("on a hop", 2 * keep)):
            count = inv.inversion_fused.split_launches
            got = fused(x[:, h:], x[:, :h])
            check(inv.inversion_fused.split_launches == count + 1,
                  "pst-long: a launch on two inputs not counted")
            check(torch.equal(got, want),
                  f"pst-long: two inputs, seam {h} ({where}), {nb} blocks: not the joined bits")
            log("pst-long", f"two inputs, seam {h} ({where}), 512 x {nb} blocks: bitwise the "
                f"launch on their join")
        del x, want, ref
        torch.cuda.empty_cache()

    # the J1909-3744 node over the cell's requests, at L 512 and at L 256
    block, reqs = 1600, 8
    gen.manual_seed(SEED + 26)
    stream = torch.randn((2, 256 * n_chan, reqs * block), dtype=torch.complex64, device=dev,
                         generator=gen)
    rows = {}
    for length in (512, 256):
        nd = TwoStageInverseFilterBank(pst1909_stage(length), nch2=216, device=dev,
                                       dedispersion=band)
        times, outs, emitted, counts = [], [], 0, None
        for rnd in range(2):  # the first round warms up
            state = nd.init_state()
            ws = reset_counts()
            retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
            collections = gc.get_stats()[2]["collections"]
            split = inv.inversion_fused.split_launches
            for i in range(reqs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                with plain_versions_raise(torch):
                    state, out = nd.execute(state, stream[:, :, i * block:(i + 1) * block])
                end.record()
                end.synchronize()
                if rnd:
                    times.append(start.elapsed_time(end))
                    outs.append(out.shape[-1])
                    emitted += out.shape[-1]
                del out
            counts = read_counts(torch, ws)
            check(inv.inversion_fused.split_launches == split + reqs - 1,
                  f"pst-long node at L {length}: not one launch on two inputs a request after "
                  f"the first")
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
        collections = gc.get_stats()[2]["collections"] - collections
        expect_launches(f"pst-long node at L {length}", counts, ("inversion_fused",),
                        composed=False)
        check(counts["inversion_fused"] == reqs,
              f"pst-long node at L {length}: {counts['inversion_fused']} launches")
        ng = nd._geom
        # ns an output sample, each request's time over what it emitted
        rows[length] = statistics.median(t * 1e6 / o for t, o in zip(times, outs) if o)
        log("pst-long", f"J1909-3744 node at L {length} (hop {ng.input_keep}, discard "
            f"{ng.input_overlap} a side): {reqs} requests of 2 x 256 x 216 x {block}, ms "
            + " ".join(f"{t:.3f}" for t in times) + f" ({retries} allocator retries, "
            f"{collections} full garbage collections); "
            f"{emitted / reqs:.0f} output samples a "
            f"request, median {rows[length]:.4f} ns a stream's output sample, "
            f"{ng.output_fft_length / ng.output_keep:.3f} transform points an output sample "
            f"({smi})")
        del nd, state
        torch.cuda.empty_cache()
    log("pst-long", f"L 256 over L 512: {rows[256] / rows[512]:.2f}x the time an output sample "
        f"({smi})")
    del stream


# ---------------------------------------------------------------------------
# phases 13-14: the file-level data_gen tools and the CLI drivers
# ---------------------------------------------------------------------------

PRODUCTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "products")
#: the mid data_gen tone, in cycles per sample (an integer bin of 4,587,520)
MID_TONE = 0.1
#: the low main path: the analysis, then the fused inversion
LOW_KERNELS = ("analysis_fused", "inversion_fused")
#: the low chain on a 2-D mesh: its corner turn sits between the frontend
#: and the epilogue, so it runs the two kernels
LOW_CORNER_TURN_KERNELS = ("analysis_fused", "synthesis_fused", "ifft_fused")
MID_KERNELS = ("analysis_padded_fused", "chan_dft_fused", "synthesis_fused", "ifft_big_inner",
               "ifft_big_outer")
PAIR = ("ifft_big_inner", "ifft_big_outer")
#: at3 565's SNRs against the committed report, dB
AT3_TOL_DB = 0.5


def stage_line(timers):
    """"name: stage s, ..." of each StageTimer, and their sum in seconds."""
    parts, total = [], 0.0
    for name, t in timers.items():
        total += sum(t.seconds.values())
        parts.append(f"{name}: " + ", ".join(f"{k} {v:.3f} s" for k, v in t.seconds.items()))
    return "; ".join(parts), total


def data_gen_round_trip(torch, dev, smi, tmp, name):
    """One file-level round trip at production width on the card, under
    plain_versions_raise: generate_test_vector -> channelize -> synthesize
    through pipeline, then dispose. Checks the launches, the synthesized
    file against the plain chain on the card (read from the same files);
    returns the (input, channelized, synthesized) DADAFiles."""
    from ska_pst_dsp_tpu_torch import data_gen
    from ska_pst_dsp_tpu_torch.io import dada
    from ska_pst_dsp_tpu_torch.ops import analysis as pa
    from ska_pst_dsp_tpu_torch.ops import synthesis as ps
    from ska_pst_dsp_tpu_torch.utils.config import load_config
    from ska_pst_dsp_tpu_torch.utils.profiling import StageTimer

    cfg = load_config(name)
    filt = cfg.load_fir_filter_coeff()  # designed and cached before channelize reads it
    check(os.path.exists(cfg.fir_filter_path), f"{cfg.fir_filter_path} not cached")
    padded = name == "mid"
    n_dat, tone = (MID_N_DAT, MID_TONE) if padded else (N_DAT, TONE)
    timers = {"channelize": StageTimer(dev), "synthesize": StageTimer(dev)}
    pipe = data_gen.pipeline(
        data_gen.generate_test_vector(domain_name="freq", n_bins=n_dat),
        data_gen.channelize(channels=cfg.channels, os_factor_str=str(cfg.os_factor),
                            fir_filter_path=cfg.fir_filter_path, use_padded=padded,
                            device=dev, timer=timers["channelize"]),
        data_gen.synthesize(input_fft_length=cfg.input_fft_length,
                            input_overlap=cfg.input_overlap, device=dev,
                            timer=timers["synthesize"]),
        output_dir=tmp,
    )
    ws = reset_counts()
    t0 = time.perf_counter()
    with plain_versions_raise(torch):
        files = pipe([tone], [0.0], n_pol=2)
    wall = time.perf_counter() - t0
    counts = read_counts(torch, ws)
    expect_launches(f"data_gen-{name}", counts, MID_KERNELS if padded else LOW_KERNELS,
                    composed=False)
    src, chan, synth = files
    check(src.data.shape == (n_dat, 1, 2) and synth.ndat > 0
          and np.isfinite(synth.data_pft).all(), f"data_gen-{name}: output {synth.data.shape}")
    # the plain chain on the card, from the same input file and the
    # channelized file's header filter
    x = torch.as_tensor(src.data_pft, device=dev)
    plain_chan = (pa.polyphase_analysis_padded if padded else pa.polyphase_analysis)(
        x, filt, cfg.channels, cfg.os_factor)
    aerr = rel_err(torch.as_tensor(chan.data_pft, device=dev), plain_chan)
    check(aerr[1] <= (PADDED_TOL if padded else ANALYSIS_TOL),
          f"data_gen-{name}: channelized vs plain {aerr[1]:.3g}")
    hdr_filt = dada.get_fir_filters_from_header(chan.header)[0][0]
    plain = ps.polyphase_synthesis(plain_chan, cfg.input_fft_length, cfg.os_factor,
                                   input_overlap=cfg.input_overlap, deripple_coeff=hdr_filt,
                                   temporal_taper="tukey")
    serr = rel_err(torch.as_tensor(synth.data_pft, device=dev), plain)
    check(serr[1] <= SYNTHESIS_TOL, f"data_gen-{name}: synthesized vs plain chain {serr[1]:.3g}")
    stages, in_stages = stage_line(timers)  # the counted pass's, before the profiled ones
    busy, top, copies = breakdown(torch, lambda: pipe([tone], [0.0], n_pol=2))
    log("data_gen", f"{name}: {tuple(src.data_pft.shape)} -> {tuple(chan.data_pft.shape)} -> "
        f"{tuple(synth.data_pft.shape)}; launches {counts}; channelized vs plain "
        f"max|err|/scale {aerr[1]:.3g}, synthesized vs plain chain {serr[1]:.3g} (tol "
        f"{SYNTHESIS_TOL}); {wall:.3f} s in all, {wall - in_stages:.3f} s of it outside the "
        f"stages: the test vector made and written, each product read back ({stages}); a second pass on the device (torch.profiler): busy "
        f"{busy:.3f} ms, of which host <-> device copies {copies:.3f} ms and kernels "
        f"{busy - copies:.3f} ms (largest: {top}): "
        f"{100 * (1 - (busy - copies) / 1e3 / wall):.2f} % of the wall time outside the "
        f"kernels ({smi})")
    return files


def run_data_gen(torch, dev, smi):
    """Phase 13: the file-level data_gen tools on the card, in a temporary
    directory, with the plain versions and torch.fft patched to raise.
    Low: a complex sinusoid of 2 pol x 2^23 through pipeline (kernels 1-3),
    the synthesized file within 1.2e-5 * scale of the plain chain on the
    card, its headers equal to the numpy backend's, and on a 2^19-sample
    prefix the numpy (fp64 oracle) backend within 3e-6 * scale. Mid:
    channelize --use-padded at 4096 channels over 2 pol x 4,587,520, then
    synthesize (kernels 4, 5, 2, 6, 7), within 1.2e-5 * scale of plain.
    dispose removes every product but the test vector."""
    from ska_pst_dsp_tpu_torch import data_gen
    from ska_pst_dsp_tpu_torch.io import dada
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    with tempfile.TemporaryDirectory() as tmp:
        src, chan, synth = data_gen_round_trip(torch, dev, smi, tmp, "low")
        data, header = dada.load(src.file_path, count=PREFIX)
        prefix = os.path.join(tmp, "prefix.dump")
        dada.save(prefix, data, header)
        cfg = load_config("low")
        t0 = time.perf_counter()
        np_chan = data_gen.channelize(prefix, channels=cfg.channels,
                                      os_factor_str=str(cfg.os_factor),
                                      fir_filter_path=cfg.fir_filter_path,
                                      backend="numpy", output_dir=tmp,
                                      output_file_name="channelized.prefix.dump")
        np_synth = data_gen.synthesize(np_chan.file_path, input_fft_length=cfg.input_fft_length,
                                       input_overlap=cfg.input_overlap, backend="numpy",
                                       output_dir=tmp, output_file_name="synthesized.prefix.dump")
        np_s = time.perf_counter() - t0
        check(np_chan.header == chan.header and np_synth.header == synth.header,
              "data_gen-low: headers differ from the numpy backend's")
        n = np_synth.ndat
        ref = np_synth.data_pft
        got = synth.data_pft[:, :, :n]
        oerr = float(np.abs(got - ref).max() / np.abs(ref).max())
        check(n > 0 and oerr <= ORACLE_TOL, f"data_gen-low: vs numpy oracle {oerr:.3g}")
        log("data_gen", f"low: headers equal the numpy backend's; on a {PREFIX}-sample prefix "
            f"the numpy (fp64 oracle) backend's {n} samples agree within max|err|/scale "
            f"{oerr:.3g} (tol {ORACLE_TOL}); the oracle took {np_s:.2f} s on the host")
        with data_gen.dispose(src, chan, synth, np_chan, np_synth):
            pass
        check(sorted(os.listdir(tmp)) == sorted([os.path.basename(src.file_path),
                                                 "prefix.dump"]),
              f"data_gen: dispose left {sorted(os.listdir(tmp))}")
        del src, chan, synth, np_chan, np_synth, data
        files = data_gen_round_trip(torch, dev, smi, tmp, "mid")
        with data_gen.dispose(*files, dispose_all=True):
            pass


def sweep_kernels(cfg, extra):
    """(the kernels a test_sgcht case launches, whether its inversion's
    epilogue is composed by design): the 36864-point (critical) inversions
    have no epilogue plan in either package and no fused kernel; the
    combine-16 inversions (589824 points) run on the ifft_big pair, mid's
    single stage on the pair, low's and the 41472-point ones (LowCBF's 216
    kept channels) on the fused inversion."""
    if cfg is None:
        return (), False
    fwd = ("analysis_padded_fused", "chan_dft_fused") if cfg == "mid" else ("analysis_fused",)
    if "--invert" not in extra:
        return fwd, False
    if "--combine" in extra or cfg == "mid":
        epi = PAIR
    elif "--critical" in extra:
        epi = ()
    else:
        return fwd + ("inversion_fused",), False
    return fwd + ("synthesis_fused",) + epi, not epi


class SweepGuard:
    """Stands in for sgcht.run inside test_sgcht: each case runs with the
    plain versions (and, unless its epilogue is composed by design,
    torch.fft) patched to raise, from launch counts set to 0; its launches
    must be the kernels :func:`sweep_kernels` names, and its composed
    epilogues one per inversion where composed, else none. A breach
    raises, which test_sgcht reports as a FAIL."""

    def __init__(self, torch, run):
        from ska_pst_dsp_tpu_torch.utils import profiling

        self.torch, self.run, self.profiling = torch, run, profiling
        self.cases = []

    def __call__(self, argv):
        torch, profiling = self.torch, self.profiling
        cfg = argv[argv.index("--cfg") + 1] if "--cfg" in argv else None
        kernels, composed = sweep_kernels(cfg, argv)
        timers = []

        class Recorded(profiling.StageTimer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                timers.append(self)

        ws = reset_counts()
        t0 = time.perf_counter()
        with plain_versions_raise(torch, composed=composed), \
                mock.patch.object(profiling, "StageTimer", Recorded):
            rc = self.run(argv)
        seconds = time.perf_counter() - t0
        counts = read_counts(torch, ws)
        label = " ".join(argv[:argv.index("--device")])
        self.cases.append({"label": label, "rc": rc, "seconds": seconds, "counts": counts,
                           "stages": dict(timers[0].seconds) if timers else {}})
        expect_launches(f"sweep {label}", counts, kernels, composed)
        return rc


def sweep(torch, smi, cfg, extra=()):
    """test_sgcht -c cfg on the card through SweepGuard; each label's status
    must equal the JAX package's committed report's."""
    from ska_pst_dsp_tpu_torch.cli import test_sgcht

    guard = SweepGuard(torch, test_sgcht.sgcht.run)
    with open(os.path.join(PRODUCTS, f"report.test_sgcht.{cfg}.json")) as f:
        committed = {k: v["status"] for k, v in json.load(f).items()}
    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(test_sgcht.sgcht, "run", guard):
        report = os.path.join(tmp, "report.json")
        t0 = time.perf_counter()
        rc = test_sgcht.run(["-c", cfg, "--report", report, *extra])
        seconds = time.perf_counter() - t0
        with open(report) as f:
            got = json.load(f)
    for label, r in got.items():
        if r["status"] == "FAIL":
            log("drivers", f"test_sgcht -c {cfg}: FAIL {label}: {r.get('error', r.get('rc'))}")
    statuses = {k: v["status"] for k, v in got.items()}
    check(set(statuses) <= set(committed) and (extra or set(statuses) == set(committed)),
          f"test_sgcht -c {cfg}: labels {sorted(set(statuses) ^ set(committed))} differ "
          "from the committed report's")
    want = {k: committed[k] for k in statuses}
    check(statuses == want, f"test_sgcht -c {cfg}: statuses {statuses} != committed {want}")
    stages = {}
    for case in guard.cases:
        for k, v in case["stages"].items():
            stages[k] = stages.get(k, 0.0) + v
        launched = {k: v for k, v in case["counts"].items() if v}
        log("drivers", f"test_sgcht -c {cfg}: {case['label']}: rc {case['rc']}, "
            f"{case['seconds']:.2f} s (" + ", ".join(f"{k} {v:.2f} s" for k, v in
                                                      case["stages"].items())
            + f"); launches {launched}")
    log("drivers", f"test_sgcht -c {cfg} {' '.join(extra)}: rc {rc}, {len(got)} cases "
        f"({sum(s == 'PASS' for s in statuses.values())} PASS, "
        f"{sum(s == 'SKIP' for s in statuses.values())} SKIP), every status as committed; "
        f"{seconds:.2f} s in all, of which sgcht stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items()) + f" ({smi})")
    return seconds


def run_drivers(torch, smi):
    """Phase 14: the CLI drivers on the card at their defaults. test_sgcht
    -c low and -c lowpsi (16 cases each) and -c mid's single-stage cases at
    the committed report's block size, each status equal to the committed
    products/report.test_sgcht.<cfg>.json; current_performance -c low -d
    both -n 8 --strict (every in-window point at <= -60 dB); at3 565, each
    variant's SNR within 0.5 dB of the committed products/report.at3_565.json.
    Reports and files go to temporary directories."""
    from ska_pst_dsp_tpu_torch.cli import at3, current_performance

    sweep(torch, smi, "low")
    sweep(torch, smi, "lowpsi")
    sweep(torch, smi, "mid", ("--subset", "3", "--blocksz", "1048576"))

    with tempfile.TemporaryDirectory() as tmp:
        ws = reset_counts()
        t0 = time.perf_counter()
        with plain_versions_raise(torch):
            rc = current_performance.run(["-c", "low", "-d", "both", "-n", "8", "--strict",
                                          "--output_dir", tmp])
        seconds = time.perf_counter() - t0
        counts = read_counts(torch, ws)
        expect_launches("current_performance", counts, LOW_KERNELS, composed=False)
        written = os.listdir(tmp)
        check(len(written) == 1 and written[0].startswith("performance.both.low."),
              f"current_performance wrote {written}")
        with open(os.path.join(tmp, written[0])) as f:
            report = json.load(f)
    points = [r for rs in report.values() for r in rs]
    judged = [r["max_spurious"] for r in points if "max_spurious" in r and r.get("in_window", True)]
    check(rc == 0 and judged and max(judged) <= PURITY_DB,
          f"current_performance: rc {rc}, worst {max(judged, default=None)} dB")
    log("drivers", f"current_performance -c low -d both -n 8 --strict: rc {rc}; "
        f"{len(report['temporal'])} impulse offsets, {len(report['spectral'])} tones; "
        f"{len(judged)} in-window points, worst max spurious {max(judged):.2f} dB <= "
        f"{PURITY_DB} dB; launches {counts}; {seconds:.2f} s ({smi})")

    with open(os.path.join(PRODUCTS, "report.at3_565.json")) as f:
        committed = json.load(f)["variants"]
    with tempfile.TemporaryDirectory() as tmp:
        rpt = os.path.join(tmp, "report.json")
        ws = reset_counts()
        t0 = time.perf_counter()
        with plain_versions_raise(torch):
            rc = at3.run_565(["--output_dir", tmp, "--report", rpt])
        seconds = time.perf_counter() - t0
        counts = read_counts(torch, ws)
        expect_launches("at3 565", counts, ("analysis_fused",), composed=False)
        with open(rpt) as f:
            got = json.load(f)["variants"]
    check(rc == 0 and sorted(got) == sorted(committed),
          f"at3 565: rc {rc}, variants {sorted(got)}")
    diffs = {tag: got[tag]["snr_db"] - committed[tag]["snr_db"]
             for tag in got if "snr_db" in committed[tag]}
    log("drivers", "at3 565: snr_db " + ", ".join(
        f"{tag} {got[tag]['snr_db']:.2f} (committed {committed[tag]['snr_db']:.2f})"
        for tag in diffs) + f"; launches {counts}; {seconds:.2f} s ({smi})")
    check(all(abs(d) <= AT3_TOL_DB for d in diffs.values()),
          f"at3 565: snr_db off the committed report by {diffs} (tol {AT3_TOL_DB} dB)")


# ---------------------------------------------------------------------------
# phase 15: the verification harness, the analysis tools and the on-card tools
# ---------------------------------------------------------------------------

TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
#: a spurious power at or below this measured an untouched stream, not the
#: inversion (the metrics' 1e-13 floor is -130 dB)
FLOOR_DB = -120.0
#: tests/test_reference_anchor.py's vector
ANCHOR_N, ANCHOR_BIN, ANCHOR_OFFSET = 442368, 377475, 0.11
#: the matrix's multi-channel cases: 16 groups, two inversions each, three
#: (deripple, window) combinations
MATRIX_GROUP_INVERSIONS = 3 * 16 * 2


@contextlib.contextmanager
def kernels_only(torch):
    """plain_versions_raise(composed=True), with the plain epilogue allowed
    only at a length for which neither package has an epilogue plan (at any
    other it raises) and torch.fft only inside that epilogue and inside
    dedisperse's whole-stream chirp: the two places no kernel takes."""
    from ska_pst_dsp_tpu_torch.ops import dedispersion as dd
    from ska_pst_dsp_tpu_torch.ops import synthesis as ps
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import epilogue_plan

    inside = [0]
    epilogue = ps.epilogue

    def scoped(fn):
        def call(*args, **kwargs):
            inside[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                inside[0] -= 1
        return call

    def planless_epilogue(flat, elem, lo, *args):
        n = flat.shape[-1]
        if epilogue_plan(n, lo)[0] != "composed":
            raise AssertionError(f"the plain epilogue ran at {n} points, which have a plan")
        return scoped(epilogue)(flat, elem, lo, *args)

    def fft_guard(fn):
        def call(*args, **kwargs):
            if not inside[0]:
                raise AssertionError("torch.fft ran outside dedisperse and a planless epilogue")
            return fn(*args, **kwargs)
        return call

    with plain_versions_raise(torch, composed=True), contextlib.ExitStack() as stack:
        for mod_name, mod in list(sys.modules.items()):
            if (mod_name.startswith("ska_pst_dsp_tpu_torch")
                    and getattr(mod, "epilogue", None) is epilogue):
                stack.enter_context(mock.patch.object(mod, "epilogue", planless_epilogue))
        stack.enter_context(mock.patch.object(dd, "dedisperse", scoped(dd.dedisperse)))
        for name in FFT_NAMES:
            stack.enter_context(mock.patch.object(torch.fft, name,
                                                  fft_guard(getattr(torch.fft, name))))
        yield


def verify_run(torch, label, fn, kernels, composed=0, guard=True):
    """One run of phase 15 from launch counts set to 0, under kernels_only
    unless ``guard`` is False: it launched exactly ``kernels``, each at
    least once, and ran ``composed`` composed epilogues. Returns (its
    result, its seconds, its counts)."""
    ws = reset_counts()
    t0 = time.perf_counter()
    with kernels_only(torch) if guard else contextlib.nullcontext():
        out = fn()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(torch, ws)
    ran = sorted(k for k, v in counts.items() if v > 0 and k != "composed_epilogues")
    check(ran == sorted(kernels), f"{label}: launched {ran}, expected {sorted(kernels)}")
    check(counts["composed_epilogues"] == composed,
          f"{label}: {counts['composed_epilogues']} composed epilogues, expected {composed}")
    return out, seconds, counts


def judged_purity(rows, used, domain, n_samples, shift):
    """The spurious powers phase 15 gates of a purity sweep: impulses inside
    the inverted window, tones at a whole bin of the measured spectrum (a
    tone between bins scores the window's scalloping, -2 dB, in both
    packages); ``used`` holds each point's compared length."""
    out = []
    for r, n in zip(rows, used):
        if (shift <= r["arg"] < shift + n if domain == "time"
                else r["arg"] * n % n_samples == 0):
            out.append(r["max_spurious_power"])
    return out


def purity_sweeps(torch, dev, smi, tmp):
    """Phase 15a: verify.purity at low (-t -f -n 8, then the five block-seam
    impulses) and at mid (-t -f -n 4)."""
    from ska_pst_dsp_tpu_torch import data_gen
    from ska_pst_dsp_tpu_torch.utils import geometry
    from ska_pst_dsp_tpu_torch.utils.config import load_config
    from ska_pst_dsp_tpu_torch.verify import purity

    used = []
    chop = purity.TestPurity.chop

    def recording_chop(self, a, b):
        inp, inv = chop(self, a, b)
        used.append(min(inp.size, inv.size))
        return inp, inv

    def seams():
        cfg = load_config("low")
        p = purity.TestPurity(
            n_test=2, os_factor=cfg.os_factor, input_fft_length=cfg.input_fft_length,
            input_overlap=cfg.input_overlap, fft_window=cfg.temporal_taper,
            deripple=cfg.deripple, channels=cfg.channels, fir_filter_taps=cfg.fir_filter_taps,
            blocks=cfg.blocks, fir_filter_path=cfg.fir_filter_path, output_dir=tmp,
            make_plots=False, device=dev)
        seam = p.total_sample_shift + p.block_size - 2 * p.output_sample_shift
        p.time_domain_args["offset"] = [seam, seam - 1, seam + 1, seam - p.output_sample_shift,
                                        seam + p.output_sample_shift]
        return p.temporal_purity()

    with mock.patch.object(purity.TestPurity, "chop", recording_chop), \
            mock.patch.object(data_gen.config.config, "data_dir", tmp):
        for name, argv, kernels in (
                ("low", ["-t", "-f", "-n", "8", "-c", "low"], LOW_KERNELS),
                ("low seams", None, LOW_KERNELS),
                ("mid", ["-t", "-f", "-n", "4", "-c", "mid"], MID_KERNELS)):
            argv = argv and argv + ["--device", str(dev)]
            used.clear()
            if argv is None:
                rows, seconds, _ = verify_run(torch, f"purity {name}", seams, kernels)
                judged = [r["max_spurious_power"] for r in rows]
            else:
                path, seconds, _ = verify_run(torch, f"purity {name}",
                                              lambda: purity.run(argv), kernels)
                check(path.endswith(f".{dev.type}.json"), f"purity report {path}")
                with open(path) as f:
                    report = json.load(f)
                cfg = load_config(argv[argv.index("-c") + 1])
                n_samples = (cfg.os_factor.normalize(cfg.input_fft_length) * cfg.channels
                             * cfg.blocks)
                shift = geometry.total_sample_shift(
                    cfg.channels, cfg.os_factor, cfg.fir_filter_taps, cfg.input_overlap,
                    padded=cfg.analysis_function == "polyphase_analysis_padded")
                t_rows = report["test_time_domain_impulse"]
                t_j = judged_purity(t_rows, used, "time", n_samples, shift)
                f_j = judged_purity(report["test_complex_sinusoid"], used[len(t_rows):],
                                    "freq", n_samples, shift)
                check(t_j and f_j,
                      f"purity {name}: judged {len(t_j)} impulses and {len(f_j)} tones")
                judged = t_j + f_j
            worst, best = max(judged), min(judged)
            check(worst <= PURITY_DB and best > FLOOR_DB,
                  f"purity {name}: judged max spurious in [{best:.2f}, {worst:.2f}] dB")
            log("verify", f"purity {name}: {len(judged)} judged points of {len(used)}, max "
                f"spurious in [{best:.2f}, {worst:.2f}] dB (gate <= {PURITY_DB}, > {FLOOR_DB}); "
                f"{seconds:.2f} s ({smi})")


def read_report(directory, name):
    with open(os.path.join(directory, name)) as f:
        return json.load(f)


def verify_modules(torch, dev, smi, tmp):
    """Phase 15b-e: the channelizer backends, the cross-implementation suite,
    the dedispersion test and the 12-case matrix, through their CLIs (the
    cross-implementation suite through run_suite, at the anchor vector)."""
    from ska_pst_dsp_tpu_torch.utils.config import load_config
    from ska_pst_dsp_tpu_torch.verify import (
        test_backends, test_cross_implementation, test_dedispersion,
    )
    from ska_pst_dsp_tpu_torch.verify import verify_dspsr_pfb_inversion as matrix

    on = ["--device", str(dev)]
    tag = dev.type
    for argv, kernels in ((["-c", "low"], ("analysis_fused",)),
                          (["-c", "mid", "--use-padded"], MID_KERNELS[:2])):
        rc, seconds, _ = verify_run(torch, f"backends {argv}",
                                    lambda: test_backends.run(argv + on), kernels)
        r = read_report(tmp, f"report.backends.{tag}.json")
        check(rc == 0 and r["mean_close"] == 1.0, f"backends {argv}: rc {rc}, {r}")
        log("verify", f"test_backends {' '.join(argv)}: mean_close {r['mean_close']} of "
            f"{r['n_compared']} (gate 1.0), max|diff|/scale {r['max_rel_diff']:.3g}; "
            f"{seconds:.2f} s ({smi})")

    rep, seconds, _ = verify_run(
        torch, "cross_impl", lambda: test_cross_implementation.run_suite(
            load_config("low"), n_bins=ANCHOR_N, offset=ANCHOR_OFFSET, freq=ANCHOR_BIN,
            output_dir=os.path.join(tmp, "cross_impl"), device=dev), LOW_KERNELS)
    entries = {k: v[0] for k, v in rep.items()}
    check(len(entries) == 3 and all(e["mean"] > 0.999 for e in entries.values()),
          f"cross_impl: {entries}")
    log("verify", "test_cross_implementation -c low (442368 samples, bin 377475, "
        "offset 0.11): " + ", ".join(f"{k.removeprefix('test_')} mean {e['mean']} of "
                                     f"{e['n']}, max|diff|/scale {e['max_rel_diff']:.3g}"
                                     for k, e in entries.items())
        + f" (gate mean > 0.999); {seconds:.2f} s ({smi})")

    for name, kernels in (("low", LOW_KERNELS), ("mid", MID_KERNELS)):
        rc, seconds, _ = verify_run(torch, f"dedispersion {name}",
                                    lambda: test_dedispersion.run(["-c", name] + on), kernels)
        r = read_report(tmp, f"report.dedispersion.{tag}.json")
        check(rc == 0 and r["mean_diff_db"] < -50, f"dedispersion {name}: rc {rc}, {r}")
        log("verify", f"test_dedispersion -c {name}: dm {r['dm']}, mean "
            f"{r['mean_diff_db']:.2f} dB (gate < -50), max {r['max_diff_db']:.2f} dB, "
            f"folded {r['folded_mean_diff_db']:.2f} dB over {r['n_compared']} samples; "
            f"{seconds:.2f} s ({smi})")

    # at low the full-band inversions run fused, the channel groups' composed
    for name, kernels, composed in (("low", LOW_KERNELS + ("synthesis_fused",),
                                     MATRIX_GROUP_INVERSIONS), ("mid", MID_KERNELS, 0)):
        # a directory each: the drift baseline is the previous report's
        out = os.path.join(tmp, f"matrix-{name}")
        os.makedirs(out)
        with mock.patch.object(matrix, "products_dir", out):
            rc, seconds, counts = verify_run(torch, f"matrix {name}",
                                             lambda: matrix.run(["-c", name] + on), kernels,
                                             composed)
        r = read_report(out, f"report.verify_pfb_inversion.{tag}.json")
        check(rc == 0 and len(r) == 12 and all(v["ok"] for v in r.values()),
              f"matrix {name}: rc {rc}")
        if name == "mid":  # the single-channel inversions, then the groups on the pair
            check(counts["ifft_big_inner"] == 6 + MATRIX_GROUP_INVERSIONS,
                  f"matrix mid: {counts['ifft_big_inner']} pair launches")
        log("verify", f"verify_dspsr_pfb_inversion -c {name}: 12 cases ok, worst mean "
            f"{max(v['mean_diff_db'] for v in r.values()):.2f} dB (gate < -38), worst max "
            f"{max(v['max_diff_db'] for v in r.values()):.2f} dB; launches {counts}; "
            f"{seconds:.2f} s ({smi})")


def mid_group_pair(torch, dev, smi):
    """The ifft_big pair at the mid matrix's group shape (114688 points at
    896 x 128), against its plain version, its bound and torch.fft.ifft."""
    from ska_pst_dsp_tpu_torch.ops import synthesis as ps
    from ska_pst_dsp_tpu_torch.ops.kernels.ifft_big import fused_big_ifft_oc
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import epilogue_plan
    from ska_pst_dsp_tpu_torch.utils import geometry
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    mid = load_config("mid")
    g = geometry.SynthesisGeometry(mid.channels // 16, mid.input_fft_length,
                                   mid.input_overlap, mid.os_factor)
    n, lo = g.output_fft_length, g.output_overlap
    n_spectra = (mid.os_factor.normalize(mid.input_fft_length) * mid.channels * mid.blocks * 2
                 // geometry.analysis_step(mid.channels, mid.os_factor))
    nb = g.n_blocks(n_spectra)
    n2, n1 = epilogue_plan(n, lo)[1:]
    flat = torch.as_tensor(noise((2, nb, n), SEED + 15), device=dev)
    gain = mid.os_factor.de / mid.os_factor.nu
    key = (n, 1, n2, n1, lo, 0, gain)
    err = measure(torch, "verify", f"ifft_big pair at {n2} x {n1} ({n} points, 2 x {nb} blocks "
                  "of a 256-channel group)",
                  lambda: fused_big_ifft_oc(flat, None, shape_key=key),
                  lambda: ps.epilogue(flat, None, lo, 0, gain, nb),
                  bound(nbytes(flat) + 2 * nb * (n - 2 * lo) * 8, fft_flops(n, 2 * nb)),
                  lambda: torch.fft.ifft(flat, dim=-1), "ifft_big", smi)
    check(err[1] <= BIG_IFFT_TOL, f"pair at {n}: {err[1]:.3g}")


def tools_on_card(torch, dev, smi, tmp):
    """Phase 15f: tools/purity_cuda.py at low and mid, and
    tools/dedispersion_cuda.py, loaded from the checkout."""
    import importlib.util

    def tool(name):
        spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    purity_cuda, dedispersion_cuda = tool("purity_cuda"), tool("dedispersion_cuda")
    for name, npoints, kernels in (("low", 16, LOW_KERNELS), ("mid", 6, MID_KERNELS)):
        path = os.path.join(tmp, f"report.purity.cuda.{name}.json")
        rc, seconds, _ = verify_run(torch, f"purity_cuda {name}",
                                    lambda: purity_cuda.main(["-c", name, "-n", str(npoints),
                                                              "--out", path]), kernels)
        r = read_report(tmp, os.path.basename(path))
        check(rc == 0 and r["pass"], f"purity_cuda {name}: rc {rc}")
        log("verify", f"tools/purity_cuda.py -c {name} -n {npoints}: "
            f"{len(r['temporal']) + len(r['spectral'])} points, worst in-window max spurious "
            f"{r['worst_in_window_max_spurious_dB']:.2f} dB (gate <= -60); {seconds:.2f} s "
            f"({r['nvidia_smi']})")
    # its reference is the composed chain on the card: run without the patch
    path = os.path.join(tmp, "report.dedispersion.cuda.json")
    rc, seconds, _ = verify_run(torch, "dedispersion_cuda",
                                lambda: dedispersion_cuda.main(["--out", path]),
                                LOW_KERNELS, guard=False)
    r = read_report(tmp, os.path.basename(path))
    check(rc == 0 and r["pass"], f"dedispersion_cuda: rc {rc}")
    log("verify", f"tools/dedispersion_cuda.py: fused vs composed max|diff|/scale "
        f"{r['fused_vs_composed_max_rel']:.3g} (gate < 1e-4); block-wise vs whole-stream "
        f"mean {r['blockwise_vs_wholestream_mean_db']:.2f} dB, max "
        f"{r['blockwise_vs_wholestream_max_db']:.2f} dB (recorded); {seconds:.2f} s "
        f"({r['nvidia_smi']})")


def test_vector_tree(torch, dev, smi, tmp):
    """Phase 15g: process_test_vectors --generate -n 2 at low and its 3-way
    report, then compare_dump_files on the tree's inverted and independent
    files."""
    from ska_pst_dsp_tpu_torch.analysis import compare_dump_files
    from ska_pst_dsp_tpu_torch.analysis import process_test_vectors as ptv

    base = os.path.join(tmp, "test_vectors")
    rc, seconds, _ = verify_run(
        torch, "process_test_vectors",
        lambda: ptv.run(["-c", "low", "-b", base, "--generate", "-n", "2", "--no-plot",
                         "--device", str(dev)]), LOW_KERNELS)
    r = read_report(tmp, f"report.process_test_vectors.{dev.type}.json")
    worst = max(e["time_mean_diff"]["independent_vs_inverted"] for rs in r.values()
                for e in rs)
    check(rc == 0 and len(r["time"]) == len(r["freq"]) == 2 and worst < 1e-5,
          f"process_test_vectors: rc {rc}, worst {worst:.3g}")
    _, sub = next(ptv.iter_test_vectors(base))
    meta = read_report(sub, "meta.json")
    files = [os.path.join(sub, meta[k]) for k in ("inverted_file", "independent_file")]
    rc = compare_dump_files.run([*files, "--report", os.path.join(tmp, "compare.json")])
    diff = read_report(tmp, "compare.json")["time"]["diff_0_1"]
    check(rc == 0 and diff["max"] < 1e-4, f"compare_dump_files: rc {rc}, {diff}")
    log("verify", f"process_test_vectors --generate -n 2 -c low: 4 vectors, worst "
        f"independent_vs_inverted mean |diff| {worst:.3g} (gate < 1e-5); {seconds:.2f} s; "
        f"compare_dump_files inverted vs independent: mean |diff| {diff['mean']:.3g}, max "
        f"{diff['max']:.3g} ({smi})")


def run_verify(torch, dev, smi):
    """Phase 15: the verification harness, the analysis tools and the
    on-card tools on the card (see the module docstring); every report
    goes to a temporary directory."""
    from ska_pst_dsp_tpu_torch.analysis import process_test_vectors as ptv
    from ska_pst_dsp_tpu_torch.verify import (
        purity, test_backends, test_cross_implementation, test_dedispersion,
    )
    from ska_pst_dsp_tpu_torch.verify import verify_dspsr_pfb_inversion as matrix

    mods = (purity, test_backends, test_cross_implementation, test_dedispersion, matrix, ptv)
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        for mod in mods:
            stack.enter_context(mock.patch.object(mod, "products_dir", tmp))
        purity_sweeps(torch, dev, smi, tmp)
        verify_modules(torch, dev, smi, tmp)
        mid_group_pair(torch, dev, smi)
        tools_on_card(torch, dev, smi, tmp)
        test_vector_tree(torch, dev, smi, tmp)

# --- phase 15b: the DADA ingest engine ------------------------------------

ENGINE = "native/dada_engine.cpp"
#: the engine's kernels: (name, what it replaces)
INGEST_KERNELS = (("dada_unpack", ENGINE + ":75"), ("lowcbf_unpack", ENGINE + ":209"),
                  ("dada_pack", ENGINE + ":95"))
#: the full-width files: 2 pol x 2^23 samples at each NBIT; the LowCBF
#: file holds as many complex samples in 256 channels (NBIT 16)
INGEST_NBITS = (8, 16, 32)
LOWCBF_CHAN, LOWCBF_NBIT = 256, 16
#: the NBIT of the low and mid file round trips (the kernels' JSON entries
#: are the low file's) and of the write
LOW_FILE_NBIT, MID_FILE_NBIT, WRITE_NBIT = 16, 8, 16
#: noise times this, quantised, fills the integer files
INGEST_RMS = 30.0
#: the write's scale: its products sit at whole and half integers too
WRITE_SCALE = 2.5
#: the kernels against their plain versions: an odd count (1 channel, 256
#: channels) and a view starting this many samples into its buffer
MATRIX_COUNT = {1: 1_000_003, 256: 4099}
MATRIX_LEAD = 333
INGEST_REPS = 5
#: turns each host read takes against the other
READ_REPS = 9


def same_bits(torch, a, b) -> bool:
    """a and b hold the same bits (complex64 as int32 pairs; words as they are)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_complex():
        a, b = torch.view_as_real(a).view(torch.int32), torch.view_as_real(b).view(torch.int32)
    return torch.equal(a, b)


def file_words(nbit, shape, seed):
    """Seeded words of a file: INGEST_RMS x noise rounded for the integer
    NBITs, noise for the float ones."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape, dtype=np.float32)
    if nbit <= 16:
        return np.rint(v * INGEST_RMS).astype(np.int8 if nbit == 8 else np.int16)
    return v.astype(np.float32 if nbit == 32 else np.float64)


def write_dada(path, words, header):
    """A DADA file of raw words behind the header (NDIM 2)."""
    from ska_pst_dsp_tpu_torch.io import dada

    with open(path, "wb") as f:
        f.write(dada.serialize_header({**header, "NDIM": "2"}))
        words.tofile(f)
    return path


def host_ms(torch, fn, reps=INGEST_REPS):
    """Median host-clock ms of fn() and a synchronize, after one warm-up."""
    return interleaved_ms(torch, {"": fn}, reps)[""][0]


def ingest_matrix(torch, dev):
    """Each engine kernel bitwise against its plain version on the card at
    NBIT 8, 16, 32 (and 64 for the TFP read), NPOL 1 and 2, NCHAN 1 and
    256, an odd count, on a view MATRIX_LEAD samples into its buffer (no
    tile edge). Returns the cases run."""
    from ska_pst_dsp_tpu_torch.ops.kernels import dada_unpack as du

    cases = 0
    for n_chan, count in sorted(MATRIX_COUNT.items()):
        for n_pol in (1, 2):
            w = n_pol * n_chan
            x = torch.as_tensor(noise((n_pol, n_chan, count), SEED + 30 + w), device=dev) * 60
            for nbit in (8, 16, 32, 64):
                what = f"NBIT {nbit}, {n_pol} pol x {n_chan} ch x {count}"
                words = file_words(nbit, (MATRIX_LEAD + count, n_chan, n_pol, 2),
                                   SEED + nbit + w)
                buf = torch.from_numpy(words.view(np.uint8).reshape(-1)).to(dev)
                raw = buf[MATRIX_LEAD * w * du.pair_bytes(nbit):]
                check(same_bits(torch, du.dada_unpack(raw, nbit, n_pol, n_chan, count),
                                du.dada_unpack_core(raw, nbit, n_pol, n_chan, count)),
                      f"dada_unpack vs plain, {what}")
                cases += 1
                if nbit == 64:
                    continue
                n_heaps = count // 32
                heaps = raw[:n_heaps * 32 * w * du.pair_bytes(nbit)]
                check(same_bits(torch, du.lowcbf_unpack(heaps, nbit, n_pol, n_chan, n_heaps),
                                du.lowcbf_unpack_core(heaps, nbit, n_pol, n_chan, n_heaps)),
                      f"lowcbf_unpack vs plain, {what} ({n_heaps} heaps)")
                check(same_bits(torch, du.dada_pack(x, nbit, WRITE_SCALE),
                                du.dada_pack_core(x, nbit, WRITE_SCALE)),
                      f"dada_pack vs plain, {what}")
                cases += 2
    return cases


def ingest_files(tmp):
    """The phase's files: {name: (path, nbit, n_pol, n_chan, samples)}."""
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    low_hdr = load_config("low").load_header()
    files = {}
    for nbit in INGEST_NBITS:
        files[f"low{nbit}"] = (nbit, 2, 1, N_DAT, low_hdr)
    files["mid"] = (MID_FILE_NBIT, 2, 1, MID_N_DAT, load_config("mid").load_header())
    files["lowcbf"] = (LOWCBF_NBIT, 2, LOWCBF_CHAN, N_DAT // LOWCBF_CHAN,
                       {**low_hdr, "INSTRUMENT": "LowCBF"})
    out = {}
    for i, (name, (nbit, n_pol, n_chan, n, hdr)) in enumerate(files.items()):
        shape = ((n // 32, n_chan, n_pol, 32, 2) if name == "lowcbf"
                 else (n, n_chan, n_pol, 2))
        hdr = {**hdr, "NBIT": str(nbit), "NPOL": str(n_pol), "NCHAN": str(n_chan)}
        path = write_dada(os.path.join(tmp, f"{name}.dada"),
                          file_words(nbit, shape, SEED + 40 + i), hdr)
        out[name] = (path, nbit, n_pol, n_chan, n)
    return out


def read_variants(native, path, offset, n, dev):
    """The engine's host read (``native.read_bytes``: a kept pool of threads,
    each reading one contiguous part, then one copy to the card) beside the
    same function with its threads started anew for each read, and with the
    whole window read by one ``preadv`` in the calling thread (the plain
    read: one read into pinned memory, then one copy)."""
    import concurrent.futures

    def run(pool=None, part=None):
        kept = native._pool, native.PART
        native._pool, native.PART = pool or kept[0], part or kept[1]
        try:
            return native.read_bytes(path, offset, n, dev)
        finally:
            native._pool, native.PART = kept

    return {"engine": run,
            "pool per read": lambda: run(
                pool=lambda: concurrent.futures.ThreadPoolExecutor(native.THREADS)),
            "one read": lambda: run(part=1 << 62)}


def library_unpack(torch, raw, nbit, n_pol, n_chan, n, lowcbf):
    """One torch call that computes what dada_unpack / lowcbf_unpack
    compute: the word conversion and the corner turn in one copy (a
    yardstick the port never calls)."""
    from ska_pst_dsp_tpu_torch.ops.kernels import dada_unpack as du

    words = raw.view(du.WORDS[nbit])
    if lowcbf:
        words = words.view(n // du.HEAP, n_chan, n_pol, du.HEAP, 2).permute(2, 1, 0, 3, 4)
    else:
        words = words.view(n, n_chan, n_pol, 2).permute(2, 1, 0, 3)
    out = torch.empty(words.shape, dtype=torch.float32, device=raw.device)
    return torch.view_as_complex(out.copy_(words)).view(n_pol, n_chan, n)


def interleaved_ms(torch, fns, reps):
    """Host-clock ms of each fn() and a synchronize, the fns taking turns
    after one warm-up each: {name: (median, min, max)}."""
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(reps):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: (statistics.median(v), min(v), max(v)) for k, v in times.items()}


def numpy_read(torch, dev, path):
    """The numpy path the sharded ingest took before the engine: io.dada.load,
    then complex64 on the card."""
    from ska_pst_dsp_tpu_torch.io import dada

    data, _ = dada.load(path)
    return torch.as_tensor(np.ascontiguousarray(data)).to(torch.complex64).to(dev)


def run_ingest(torch, dev, smi):
    """Phase 15b (see the module docstring). Returns the JSON entries of the
    engine's three kernels."""
    from ska_pst_dsp_tpu_torch.entry import low_round_trip, mid_round_trip
    from ska_pst_dsp_tpu_torch.io import dada, native
    from ska_pst_dsp_tpu_torch.ops.kernels import dada_unpack as du
    from ska_pst_dsp_tpu_torch.utils.profiling import clock

    t0 = time.perf_counter()
    cases = ingest_matrix(torch, dev)
    log("ingest", f"{cases} kernel cases bitwise equal to their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    low, mid = low_round_trip(dev), mid_round_trip(dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = ingest_files(tmp)
        log("ingest", f"{len(files)} files written in {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"{k} {os.path.getsize(v[0]) / 2**20:.1f} MiB" for k, v in files.items()))
        lowf, midf, lcf = (files[f"low{LOW_FILE_NBIT}"][0], files["mid"][0],
                           files["lowcbf"][0])
        out_path = write_dada(os.path.join(tmp, "write.dada"), np.zeros(0, np.int8),
                              {"NBIT": str(WRITE_NBIT), "NPOL": "2", "NCHAN": "1"})
        x_write = torch.as_tensor(noise((2, 1, N_DAT), SEED + 50), device=dev) * 60

        # the main path, counted: file -> engine -> the low and mid round
        # trips; the LowCBF file; the write and its read back
        ws = reset_counts()
        with plain_versions_raise(torch):
            low_out = low(dada.load_split(lowf, device=dev)[0][:, 0])
            mid_out = mid(dada.load_split(midf, device=dev)[0][:, 0])
            lc, _ = dada.load_split(lcf, device=dev)
            native.append_split(out_path, x_write, nbit=WRITE_NBIT, scale=WRITE_SCALE)
            back, _ = dada.load_split(out_path, device=dev)
        counts = read_counts(torch, ws)
        names = [k for k, _ in INGEST_KERNELS]
        expect_launches("ingest", counts, set(LOW_KERNELS + MID_KERNELS + tuple(names)),
                        composed=False)
        log("ingest", f"main path launches: {counts}")

        # what came out
        for name, model, got, path in (("low", low, low_out, lowf), ("mid", mid, mid_out, midf)):
            ref = model(numpy_read(torch, dev, path)[:, 0])
            check(bool(torch.isfinite(torch.view_as_real(got)).all()) and same_bits(torch, got, ref),
                  f"ingest: {name} file round trip through the engine differs from the "
                  f"chain on the numpy-loaded stream")
            log("ingest", f"{name} file -> engine -> round trip {tuple(got.shape)}: bitwise equal "
                "to the chain on the numpy-loaded stream")
        check(same_bits(torch, lc, numpy_read(torch, dev, lcf)), "ingest: LowCBF read")
        v = torch.view_as_real(x_write) * torch.tensor(WRITE_SCALE, device=dev)
        want = torch.view_as_complex(torch.round(v).clamp(*du.CLIP[WRITE_NBIT]).contiguous())
        # (values: a word of 0 reads back as +0.0 where rounding gave -0.0)
        check(torch.equal(back, want), "ingest: append_split -> load_split is not the "
              "quantised stream")
        with open(out_path, "rb") as f:
            f.seek(4096)
            words = torch.frombuffer(bytearray(f.read()), dtype=torch.uint8)
        check(torch.equal(words, du.dada_pack_core(x_write, WRITE_NBIT, WRITE_SCALE).cpu()),
              "ingest: written words differ from the plain pack")
        log("ingest", f"LowCBF {tuple(lc.shape)} equal to the numpy read; append_split of "
            f"{tuple(x_write.shape)} at NBIT {WRITE_NBIT} x {WRITE_SCALE} then load_split: "
            "exactly the quantised stream, words equal to the plain pack")
        del low_out, mid_out, lc, back, want, v, low, mid
        torch.cuda.empty_cache()

        # times: the numpy path, the engine end to end and step by step
        hbm = card_peaks()[0]
        timed = {}
        for name, (path, nbit, n_pol, n_chan, n) in files.items():
            lowcbf = name == "lowcbf"
            nbytes_ = os.path.getsize(path) - 4096
            np_ms = host_ms(torch, lambda: numpy_read(torch, dev, path), reps=3)
            eng_ms = host_ms(torch, lambda: dada.load_split(path, device=dev))
            pinned = torch.empty(nbytes_, dtype=torch.uint8, pin_memory=True)
            read_ms = host_ms(torch, lambda: native.read_into(path, 4096, pinned))
            raw = torch.empty(nbytes_, dtype=torch.uint8, device=dev)
            h2d = []
            for _ in range(INGEST_REPS):
                stop = clock(dev)
                raw.copy_(pinned, non_blocking=True)
                h2d.append(stop())
            h2d_ms = statistics.median(h2d)
            if lowcbf:
                args, kern, plain = ((raw, nbit, n_pol, n_chan, n // 32), du.lowcbf_unpack,
                                     du.lowcbf_unpack_core)
            else:
                args, kern, plain = ((raw, nbit, n_pol, n_chan, n), du.dada_unpack,
                                     du.dada_unpack_core)
            out = kern(*args)
            err = float((out - plain(*args)).abs().max())
            lib = (raw, nbit, n_pol, n_chan, n, lowcbf)
            check(same_bits(torch, library_unpack(torch, *lib), out),
                  f"ingest: the library copy differs from {kern.__name__}, {name}")
            bnd = bound(nbytes(raw, out), out.numel() * 2)
            timed[name] = dict(err=err, ms=time_ms(torch, lambda: kern(*args)),
                               plain_ms=time_ms(torch, lambda: plain(*args)), bnd=bnd,
                               library_ms=time_ms(torch, lambda: library_unpack(torch, *lib)))
            variants = read_variants(native, path, 4096, nbytes_, dev)
            want = variants["engine"]()
            check(all(torch.equal(v(), want) for v in variants.values()),
                  f"ingest: the host read's variants disagree, {name}")
            reads = interleaved_ms(torch, variants, READ_REPS)
            log("ingest", f"{name}: raw bytes to the card, host ms, median (min-max) of "
                f"{READ_REPS} turns: " + "; ".join(
                    f"{k} {v[0]:.3f} ({v[1]:.3f}-{v[2]:.3f})" for k, v in reads.items())
                + f" ({smi})")
            del want
            log("ingest", f"{name} (NBIT {nbit}, {n_pol} pol x {n_chan} ch x {n}, "
                f"{nbytes_ / 2**20:.1f} MiB): numpy dada.load + to(card) {np_ms:.3f} ms; "
                f"engine load_split {eng_ms:.3f} ms ({np_ms / eng_ms:.1f}x); steps: read to "
                f"pinned {read_ms:.3f} ms ({nbytes_ / read_ms / 1e6:.2f} GB/s), H2D "
                f"{h2d_ms:.3f} ms ({nbytes_ / h2d_ms / 1e6:.2f} GB/s pinned), "
                f"{kern.__name__} {timed[name]['ms']:.4f} ms (plain "
                f"{timed[name]['plain_ms']:.4f} ms, library copy "
                f"{timed[name]['library_ms']:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) at "
                f"{hbm / 1e12:.2f} TB/s); max|err| {err} ({smi})")
            del pinned, raw, out

        # the pack at the write's shape
        words = du.dada_pack(x_write, WRITE_NBIT, WRITE_SCALE)
        pref = du.dada_pack_core(x_write, WRITE_NBIT, WRITE_SCALE)
        word = du.WORDS[WRITE_NBIT]
        perr = float((words.view(word).float() - pref.view(word).float()).abs().max())
        timed["pack"] = dict(
            err=perr, ms=time_ms(torch, lambda: du.dada_pack(x_write, WRITE_NBIT, WRITE_SCALE)),
            plain_ms=time_ms(torch, lambda: du.dada_pack_core(x_write, WRITE_NBIT, WRITE_SCALE)),
            bnd=bound(nbytes(x_write, words), x_write.numel() * 8))
        t = timed["pack"]
        log("ingest", f"dada_pack (2 x 1 x {N_DAT}, NBIT {WRITE_NBIT}): {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bnd'][0]:.4f} ms ({t['bnd'][1]}); "
            f"max|err| {perr} ({smi})")

    entries = []
    for (name, replaces), key in zip(INGEST_KERNELS, (f"low{LOW_FILE_NBIT}", "lowcbf", "pack")):
        t = timed[key]
        # dada_pack's scale, round, clip and cast is no one torch call
        entry = kernel_entry(name, "dada_unpack", replaces, (t["err"], t["err"]), 0.0, t["ms"],
                             t["plain_ms"], t["bnd"], t.get("library_ms"))
        entry["launches"] = counts[name]
        if name == "dada_unpack":
            entry["by_nbit"] = {n: {f: timed[f"low{n}"][f] for f in ("ms", "plain_ms",
                                                                       "library_ms")}
                                for n in INGEST_NBITS}
        entries.append(entry)
    return entries


# --- phase 16: the sharded pipelines -------------------------------------

#: sharded vs the one-shot kernel chain, x scale; the two-stage chains,
#: relative (tests/test_two_stage_sharded.py:76)
PARALLEL_TOL, PARALLEL_TWO_STAGE_TOL = 1e-6, 1e-4
#: 2^23 cut to a multiple of 4 * step * nu = 3072, the 1-D quantum at world 4
PARALLEL_LOW_N = N_DAT // 3072 * 3072
PARALLEL_LOW_LOW_N = 2 ** 24 // 3072 * 3072
PARALLEL_SPS_N = N_DAT // 27648 * 27648
PARALLEL_FILE_N = 2 ** 22
#: noise after the sps stream in its one-shot reference: the streaming
#: model keeps its last LowCBF spectra back until later samples arrive,
#: and the sharded chain gives them from the stream alone
PARALLEL_SPS_TAIL = 4 * 27648
PARAM_OPT_TOL_DB = 0.5
TWO_STAGE_KERNELS = ("analysis_fused", "synthesis_fused") + PAIR


def rank_guard():
    """Inside a spawned rank: the plain versions and torch.fft raise (a
    patch in the parent does not cross a spawn)."""
    import torch

    return plain_versions_raise(torch)


def parallel_cases(world, paths):
    """(name, Call, layout, dc, kernels, reference) of a world's spawn."""
    from ska_pst_dsp_tpu_torch.entry import L, N_CHAN, OS_FACTOR, OVERLAP
    from ska_pst_dsp_tpu_torch.parallel import corner_turn as ct
    from ska_pst_dsp_tpu_torch.parallel import distributed as dist_
    from ska_pst_dsp_tpu_torch.parallel import sharded as sh
    from ska_pst_dsp_tpu_torch.parallel import two_stage_sharded as ts
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    Sharded = dist_.Sharded
    # two runs a case: the second is timed, the first builds plans and tables
    Call = functools.partial(dist_.Call, runs=2)
    low = (model_filter(), N_CHAN, OS_FACTOR, L, OVERLAP)
    mid_cfg = load_config("mid")
    mid = (mid_cfg.load_fir_filter_coeff(), mid_cfg.channels, mid_cfg.os_factor,
           mid_cfg.input_fft_length, mid_cfg.input_overlap)
    x_low, x_mid = Sharded(paths["low"]), Sharded(paths["mid"])
    cases = [("low 1-D", Call(sh.sharded_round_trip, (x_low, *low)), "time", 1, LOW_KERNELS,
              "low")]
    if world == 1:
        return cases
    for dc, dt in ((2, 1),) if world == 2 else ((2, 2), (4, 1)):
        cases.append((f"low 2-D {dc} x {dt}", Call(ct.sharded_round_trip_2d, (x_low, *low),
                                                   mesh_2d=(dc, dt)), "time_chan", dc,
                      LOW_CORNER_TURN_KERNELS, "low"))
    cases.append(("mid 1-D", Call(sh.sharded_round_trip_padded, (x_mid, *mid)), "time", 1,
                  MID_KERNELS, "mid"))
    dc, dt = 2, world // 2
    cases.append((f"mid 2-D {dc} x {dt}", Call(ct.sharded_round_trip_2d_padded, (x_mid, *mid),
                                               mesh_2d=(dc, dt)), "time_chan", dc,
                  MID_KERNELS, "mid"))
    if world == 4:
        lowc, sps, lowpsi = load_config("low"), load_config("sps"), load_config("lowpsi")
        cases += [
            ("low x low critical, combine 16",
             Call(ts.sharded_two_stage_round_trip, (Sharded(paths["low_low"]), lowc, lowc),
                  dict(critical=True, combine=16)), "time", 1, TWO_STAGE_KERNELS, "low_low"),
            ("sps -> lowpsi", Call(ts.sharded_two_stage_round_trip,
                                   (Sharded(paths["sps"]), sps, lowpsi),
                                   dict(critical=True, invert=False)), "time", 1,
             ("analysis_fused",), "sps"),
            ("file round trip", Call(dist_.sharded_file_round_trip, (paths["dada"], lowc)),
             "time", 1, LOW_KERNELS + ("dada_unpack",), "file"),
        ]
    return cases


def parallel_reference(torch, dev, key, arrays, paths):
    """The one-shot chain of a case on the card: the kernel round trip, or
    the one-shot two-stage models (sps -> lowpsi on its stream and
    PARALLEL_SPS_TAIL samples of noise after it, so every spectrum the
    sharded chain gives has its one-shot counterpart)."""
    from ska_pst_dsp_tpu_torch.entry import low_round_trip, mid_round_trip
    from ska_pst_dsp_tpu_torch.io import dada
    from ska_pst_dsp_tpu_torch.models import TwoStageFilterBank, TwoStageInverseFilterBank
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    if key in ("low", "mid", "file"):
        model = mid_round_trip(dev) if key == "mid" else low_round_trip(dev)
        x = dada.load(paths["dada"])[0][:, 0] if key == "file" else arrays[key]
        return model(torch.as_tensor(x, device=dev))
    if key == "low_low":
        low = load_config("low")
        fb = TwoStageFilterBank(low, low, critical=True, device=dev)
        _, chan = fb.execute(fb.init_state(), torch.as_tensor(arrays[key], device=dev))
        inv = TwoStageInverseFilterBank(low, low, combine=16, nch2=192, device=dev)
        return inv.execute(inv.init_state(), chan)[1]
    fb = TwoStageFilterBank(load_config("sps"), load_config("lowpsi"), critical=True, device=dev)
    x = np.concatenate([arrays[key], noise((2, PARALLEL_SPS_TAIL), SEED + 21)], axis=-1)
    return fb.execute(fb.init_state(), torch.as_tensor(x, device=dev))[1]


def exchange_line(collectives):
    """"kind calls x bytes" of each exchange of scaling_bench.summarize's
    "collectives" (summed over the ranks), and the bytes staged through
    host memory."""
    return ", ".join(f"{k} {v['calls']} x, {v['bytes']} B"
                     + (f" ({v['staged_bytes']} B via host)" if v["staged_bytes"] else "")
                     for k, v in collectives.items() if v["calls"]) or "none"


def parallel_length(key, n_dat, dt, dc):
    """Samples the gathered output of a phase-16 case must hold. A round
    trip cuts its fine channels to whole inversion blocks per time shard
    (a multiple of dc of them on a 2-D mesh) and gives the one-shot count
    of that stream. A two-stage chain gives every spectrum its stages'
    valid samples make, and the combined inversion's one-shot count of
    them: sps -> lowpsi holds a LowCBF spectrum or two more than the
    streaming model gives for the same stream (it keeps them back until
    later samples arrive; see parallel_reference)."""
    from ska_pst_dsp_tpu_torch.entry import L, N_CHAN, OS_FACTOR, OVERLAP
    from ska_pst_dsp_tpu_torch.ops import lowcbf
    from ska_pst_dsp_tpu_torch.utils import geometry
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    if key in ("low_low", "sps"):
        c1, c2 = (load_config(k) for k in (("low", "low") if key == "low_low"
                                           else ("sps", "lowpsi")))
        t1 = geometry.analysis_nblocks(n_dat, c1.load_fir_filter_coeff().size, c1.channels,
                                       c1.os_factor)
        if key == "sps":
            return (t1 + lowcbf.FIRST_CALL_PAD - lowcbf.NFILT) // lowcbf.STEP
        t2 = geometry.analysis_nblocks(t1, c2.load_fir_filter_coeff().size, c2.channels,
                                       c2.os_factor)
        geom = geometry.SynthesisGeometry(c1.os_factor.normalize(c2.channels) * 16,
                                          c2.input_fft_length, c2.input_overlap, c2.os_factor)
        return geom.n_blocks(t2) * geom.output_keep
    if key == "mid":
        cfg = load_config("mid")
        t_valid = n_dat // geometry.analysis_step(cfg.channels, cfg.os_factor)
        geom = geometry.SynthesisGeometry(cfg.channels, cfg.input_fft_length,
                                          cfg.input_overlap, cfg.os_factor)
    else:
        taps = model_filter().size
        if key == "file":  # the file's stream, cut to the 1-D sharding quantum
            taps = load_config("low").load_fir_filter_coeff().size
            quantum = dt * geometry.analysis_step(N_CHAN, OS_FACTOR) * OS_FACTOR.nu
            n_dat = n_dat // quantum * quantum
        t_valid = geometry.analysis_nblocks(n_dat, taps, N_CHAN, OS_FACTOR)
        geom = geometry.SynthesisGeometry(N_CHAN, L, OVERLAP, OS_FACTOR)
    quantum = dt * geom.input_keep * dc
    return geom.n_blocks(t_valid // quantum * quantum) * geom.output_keep


def run_parallel(torch, dev, smi):
    """Phase 16 (see the module docstring)."""
    from ska_pst_dsp_tpu_torch.analysis import param_opt
    from ska_pst_dsp_tpu_torch.cli import scaling_bench
    from ska_pst_dsp_tpu_torch.entry import dryrun_multichip
    from ska_pst_dsp_tpu_torch.io import dada
    from ska_pst_dsp_tpu_torch.ops.kernels import _build
    from ska_pst_dsp_tpu_torch.parallel import distributed as dist_
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    _build.build()  # once, here: the ranks load it and never run nvcc at once
    torch.cuda.empty_cache()
    arrays = {"low": noise((2, PARALLEL_LOW_N), SEED + 16),
              "mid": noise((2, MID_N_DAT), SEED + 17),
              "low_low": noise((2, PARALLEL_LOW_LOW_N), SEED + 18),
              "sps": noise((2, PARALLEL_SPS_N), SEED + 19)}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for k, a in arrays.items():
            paths[k] = os.path.join(tmp, f"{k}.npy")
            np.save(paths[k], a)
        paths["dada"] = os.path.join(tmp, "low.dada")
        dada.save(paths["dada"], noise((2, 1, PARALLEL_FILE_N), SEED + 20),
                  load_config("low").load_header())
        for world in (1, 2, 4):
            cases = parallel_cases(world, paths)
            t0 = time.perf_counter()
            ranks = dist_.spawn(dist_.run_calls, world, timeout=600,
                                args=([c[1] for c in cases], rank_guard))
            backend = ranks[0][0]["backend"]
            log("parallel", f"world {world}: backend {backend}, ranks on "
                + ("one card each" if backend == "nccl" else "cuda:0, payloads staged "
                   "through host memory" if ranks[0][0]["staged"] else "cuda:0")
                + f"; {len(cases)} cases in {time.perf_counter() - t0:.1f} s with the rank "
                f"start-up ({smi})")
            for i, (name, call, layout, dc, kernels, key) in enumerate(cases):
                per_rank = [r[i] for r in ranks]
                for rank, r in enumerate(per_rank):
                    ran = sorted(k for k, v in r["launches"].items() if v > 0)
                    check(ran == sorted(kernels) and r["composed_epilogues"] == 0,
                          f"parallel world {world} {name}: rank {rank} launched {ran}, "
                          f"composed {r['composed_epilogues']}, expected {sorted(kernels)}")
                got = dist_.assemble([r["out"] for r in per_rank], layout, dc).to(dev)
                ref = parallel_reference(torch, dev, key, arrays, paths)
                n_dat = PARALLEL_FILE_N if key == "file" else arrays[key].shape[-1]
                n = parallel_length(key, n_dat, call.mesh_2d[1] if call.mesh_2d else world, dc)
                check(got.shape[:-1] == ref.shape[:-1] and got.shape[-1] == n
                      and 0 < n <= ref.shape[-1],
                      f"parallel world {world} {name}: {tuple(got.shape)}, want {n} samples "
                      f"of the one-shot {tuple(ref.shape)}")
                err = rel_err(got, ref[..., :n])
                tol = PARALLEL_TWO_STAGE_TOL if key in ("low_low", "sps") else PARALLEL_TOL
                check(err[1] <= tol, f"parallel world {world} {name}: {err[1]:.3g} > {tol}")
                log("parallel", f"world {world} {name}: first run "
                    f"{max(r['ms'][0] for r in per_rank) / 1e3:.3f} s, second "
                    f"{max(r['ms'][-1] for r in per_rank) / 1e3:.4f} s; second run's "
                    "compute / exchange ms per rank " + ", ".join(
                        f"{r['compute_ms']:.3f} / {r['exchange_ms']:.3f}" for r in per_rank)
                    + "; exchanges over all ranks: "
                    + exchange_line(scaling_bench.summarize(per_rank, 0, False)["collectives"])
                    + f"; launches per rank "
                    f"{per_rank[0]['launches']}; vs one-shot max|err|/scale {err[1]:.3g} "
                    f"(tol {tol}) ({smi})")
                del got, ref
            del ranks
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rep = dryrun_multichip(4, guard=rank_guard)
    log("parallel", f"dryrun_multichip(4): {time.perf_counter() - t0:.1f} s; " + "; ".join(
        f"{k} {v['error']:.3g} (gate {v['gate']})" for k, v in rep.items()) + f" ({smi})")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        check(scaling_bench.run(["--world", "1", "2", "4", "--reps", "3", "--products", tmp])
              == 0, "scaling_bench failed")
        with open(os.path.join(tmp, f"report.scaling.{dev.type}.json")) as f:
            runs = json.load(f)["runs"]
        for world, entry in runs.items():
            log("parallel", f"scaling_bench world {world}: {entry['backend']}, staged "
                f"{entry['staged']}; " + "; ".join(
                    f"{case} " + (f"{e['msps']:.1f} Msamples/s, " if "msps" in e else "")
                    + "compute ms " + ", ".join(f"{v:.3f}" for v in e["compute_ms"])
                    + ", exchange ms " + ", ".join(f"{v:.3f}" for v in e["exchange_ms"])
                    + ", " + exchange_line(e["collectives"])
                    for case, e in entry.items() if isinstance(e, dict)) + f" ({smi})")
        log("parallel", f"scaling_bench: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    got = param_opt.pipeline_study(device=dev)
    with open(os.path.join(PRODUCTS, "param_opt.pipeline.json")) as f:
        ref = json.load(f)
    worst = 0.0
    for g, r in zip(got, ref, strict=True):
        for k in ("max_spurious", "total_spurious"):
            if r[k] > -100.0:
                worst = max(worst, abs(g[k] - r[k]))
    check(worst <= PARAM_OPT_TOL_DB, f"param_opt pipeline off the committed report by {worst:.3f} dB")
    log("parallel", f"param_opt --study pipeline on the card: {time.perf_counter() - t0:.1f} s; "
        + ", ".join(f"{g['signal']} max spurious {g['max_spurious']:.2f} dB" for g in got)
        + f"; worst gap to products/param_opt.pipeline.json {worst:.3f} dB "
        f"(tol {PARAM_OPT_TOL_DB}) ({smi})")


def model_filter():
    from ska_pst_dsp_tpu_torch.design import fir
    from ska_pst_dsp_tpu_torch.entry import N_CHAN, OS_FACTOR, TAPS_PER_CHAN

    return fir.design_pfb_fir_filter(N_CHAN, OS_FACTOR, TAPS_PER_CHAN)


if __name__ == "__main__":
    sys.exit(main())
