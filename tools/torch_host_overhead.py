#!/usr/bin/env python3
"""Host time of each step of the port's kernel wrappers on one CUDA card:
the channel DFT and the frontend at the SKA-Mid main path's shapes, the
analysis and the cluster epilogue at the SKA-Low main path's.

    python3 tools/torch_host_overhead.py     # from the repository root

Each step runs ``CALLS`` times in a row; the line gives its host time per
call in microseconds (time.perf_counter, median of ``WINDOWS`` windows; the
card is synchronized between windows, and a window queues at most ``CALLS``
launches, far from the launch queue's depth). The steps are those of
``chan_dft_ramp`` and ``synthesis_fused`` in the order they run, then each
whole wrapper and the library call (torch.fft.fft) it is held against; then
the ctypes launch and the whole wrapper of ``analysis_fused`` and
``fused_big_ifft`` (the epilogue beside torch.fft.ifft), and of
``padded_fold_fused`` at the mid main path's shape, its launch with the
stream's tensor map found among those the library keeps and with it encoded
anew. Last, the program's spans (``utils/profiling.py``): a ``with
span(...)``, a call through ``spanned`` and a ``with record_function``
beside the bare call, each with no profiler recording and under a
recording ``torch.profiler``, and the lookup of the epilogue's cached plan
(the ``dispatch`` span's work) at the low and mid main paths' geometries.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

CALLS, WINDOWS = 200, 5


def host_us(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        per.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_host_overhead: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from ska_pst_dsp_tpu_torch.entry import low_round_trip, mid_round_trip
    from ska_pst_dsp_tpu_torch.ops.kernels import (
        SMEM_LIMIT, _build, device_pass_twiddles, require, stream_of,
    )
    from ska_pst_dsp_tpu_torch.ops.kernels.chan_dft_fused import chan_dft_ramp
    from ska_pst_dsp_tpu_torch.ops.kernels import analysis_padded_fused as apf
    from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import analysis_fused
    from ska_pst_dsp_tpu_torch.ops.kernels.ifft_fused import fused_big_ifft
    from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import (
        LENGTHS, epilogue_plan, synthesis_fused,
    )
    from ska_pst_dsp_tpu_torch.utils.profiling import span, spanned

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    model = mid_round_trip(dev)
    g = torch.randn((2, 1280, 4096), dtype=torch.complex64, device=dev)
    const = model.chan_const
    lib = _build.library()
    out = torch.empty_like(g)
    tw = device_pass_twiddles(4096, -1, dev)
    geom = model.geom
    L, keep = geom.input_fft_length, geom.input_keep
    kpos = (L // 2 + geom.discard) % L
    nb = geom.n_blocks(g.shape[1])
    fargs = (g, model.t_taper, model.dr, model.perm, L, keep, kpos, nb)
    fout = torch.empty((2, nb, 4096, geom.fn_width), dtype=torch.complex64, device=dev)
    ftw = device_pass_twiddles(L, -1, dev)

    low = low_round_trip(dev)
    x = torch.randn((2, 2 ** 23), dtype=torch.complex64, device=dev)
    chan = analysis_fused(x, low.f2d, low.ramp, low.step)
    lg = low.geom
    n, lo = lg.output_fft_length, lg.output_overlap
    lnb = lg.n_blocks(chan.shape[1])
    flat = torch.randn((2, lnb, n), dtype=torch.complex64, device=dev)
    key = (n, *epilogue_plan(n, lo)[1:], lo, lg.fn_width // 2, 0.75)
    ptw = device_pass_twiddles(256, -1, dev)
    phases = low.f2d.shape[0]
    nblocks = chan.shape[1]

    xm = torch.randn((2, 4_587_520), dtype=torch.complex64, device=dev)
    fp = apf.plan(4096, model.step, model.f2d_rev.shape[0])
    fold_tiles = apf.seg_tiles(fp, 1280, 2 * (fp.w // apf.C_TILE),
                               apf.resident_blocks(fp, model.f2d_rev.shape[0], dev))
    gm = torch.empty((2, 1280, 4096), dtype=torch.complex64, device=dev)
    # nine views of one buffer, 16 bytes apart: taken in turn they never find
    # their tensor map among the eight the library keeps
    xwide = torch.randn((2, 4_587_520 + 16), dtype=torch.complex64, device=dev)
    shifted = [xwide[:, 2 * i: 2 * i + 4_587_520] for i in range(9)]
    turn = iter(range(10 ** 9))

    def fold_launch(xv):
        return lib.padded_fold_launch(
            xv.data_ptr(), gm.data_ptr(), model.f2d_rev.data_ptr(), 2, xv.shape[1],
            xv.stride(0), 1280, 4096, fp.w, fp.d, fp.s, model.f2d_rev.shape[0], fold_tiles,
            SMEM_LIMIT, stream_of(xv))

    def device_context():
        with torch.cuda.device(dev):
            pass

    steps = {
        "require (2 operands)": lambda: (require(g, "g", torch.complex64, dev),
                                         require(const, "c", torch.complex64, dev)),
        "torch.empty_like": lambda: torch.empty_like(g),
        "device_pass_twiddles (cached)": lambda: device_pass_twiddles(4096, -1, dev),
        "stream_of": lambda: stream_of(g),
        "with torch.cuda.device": device_context,
        "_build.library (cached)": _build.library,
        "chan_dft_launch (ctypes, launch)": lambda: lib.chan_dft_launch(
            g.data_ptr(), out.data_ptr(), tw.data_ptr(), tw.data_ptr(), const.data_ptr(),
            2, 1280, 4096, 1, 12, const.shape[0], 0, 14, stream_of(g)),
        "chan_dft_launch refused (ctypes only)": lambda: lib.chan_dft_launch(
            g.data_ptr(), out.data_ptr(), tw.data_ptr(), tw.data_ptr(), const.data_ptr(),
            2, 1280, 4096, 5, 12, const.shape[0], 0, 14, stream_of(g)),
        "chan_dft_ramp (whole wrapper)": lambda: chan_dft_ramp(g, const, 0, 14),
        "torch.fft.fft (2, 1280, 4096)": lambda: torch.fft.fft(g, dim=-1),
        "synthesis_fused_launch (ctypes, launch)": lambda: lib.synthesis_fused_launch(
            g.data_ptr(), fout.data_ptr(), model.t_taper.data_ptr(), model.dr.data_ptr(),
            model.perm.data_ptr(), ftw.data_ptr(), *g.stride(), 2, 4096, nb, L,
            LENGTHS[L], keep, kpos, geom.fn_width, stream_of(g)),
        "synthesis_fused (whole wrapper)": lambda: synthesis_fused(*fargs),
        "analysis_fused_launch (ctypes, launch)": lambda: lib.analysis_fused_launch(
            x.data_ptr(), chan.data_ptr(), low.f2d.data_ptr(), ptw.data_ptr(), ptw.data_ptr(),
            low.ramp.data_ptr(), None, 2, x.shape[1], x.stride(0), nblocks, 256, 1, 8,
            low.step, phases, low.ramp.shape[0], 0, 0, SMEM_LIMIT, stream_of(x)),
        "analysis_fused (whole wrapper)": lambda: analysis_fused(x, low.f2d, low.ramp, low.step),
        "padded_fold_launch (ctypes, launch, tensor map kept)": lambda: fold_launch(xm),
        "padded_fold_launch (ctypes, launch, tensor map encoded)": lambda: fold_launch(
            shifted[next(turn) % 9]),
        "padded_fold_fused (whole wrapper)": lambda: apf.padded_fold_fused(
            xm, model.f2d_rev, model.step),
        "fused_big_ifft (whole wrapper)": lambda: fused_big_ifft(flat, None, shape_key=key),
        "torch.fft.ifft (2, B, 49152)": lambda: torch.fft.ifft(flat, dim=-1),
    }

    def in_span():
        with span("x"):
            pass

    def bare():
        pass

    def route(g):
        return epilogue_plan(g.output_fft_length, g.output_overlap)

    def in_record_function():
        with torch.profiler.record_function("x"):
            pass

    spans = {"bare call": bare, "with span (empty)": in_span,
             "spanned call (empty)": spanned("x")(bare),
             "with torch.profiler.record_function (empty)": in_record_function}
    steps.update({f"{k}, no profiler": fn for k, fn in spans.items()})
    steps["epilogue_plan (low, cluster)"] = lambda: route(lg)
    steps["epilogue_plan (mid, pair)"] = lambda: route(geom)
    with torch.cuda.device(dev):
        for name, fn in steps.items():
            print(f"[host] {name}: {host_us(torch, fn):.2f} us per call ({smi})", flush=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            for name, fn in spans.items():
                print(f"[host] {name}, profiler recording: {host_us(torch, fn):.2f} us per "
                      f"call ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
