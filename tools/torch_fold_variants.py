#!/usr/bin/env python3
"""Tile sizes of the padded (SKA-Mid) fold kernel, timed on one CUDA card.

    python3 tools/torch_fold_variants.py     # from the repository root

``csrc/analysis_padded_fused.cu`` fixes its spectra per tile, columns per
work unit and threads per block as the constants kSpec, kCols and kThreads.
This script writes a copy of the source per variant below with other values
in those three lines, compiles each into its own library, and for every run
length that fits in shared memory folds the mid main path's stream (2 pol x
4,587,520 samples, 25 phases x 4096 at hop 3584): the result is held to the
plain version (1e-5 x scale), then timed back to back with CUDA events
(median of ``WINDOWS`` windows of ``CALLS`` calls). One line per (variant,
run length) with the kernel's registers and spills from ``ptxas -v`` and
the staging factor of the input; the plan of a variant (rows of a tile's
window, of a box, of a run) is computed here as the wrapper computes the
committed kernel's.
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile

#: (spectra per tile, columns per unit, threads per block); the first is
#: the committed kernel's
VARIANTS = ((32, 16, 512), (32, 32, 512), (64, 16, 512), (64, 32, 512), (32, 64, 512),
            (16, 32, 512), (32, 32, 1024), (32, 32, 256))
CALLS, WINDOWS = 20, 5
TOL = 1e-5


def variant_source(text: str, spec: int, cols: int, threads: int) -> str:
    """The kernel's source with the three tile constants set."""
    for name, value in (("kSpec", spec), ("kCols", cols), ("kThreads", threads)):
        text, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"analysis_padded_fused.cu: no single definition of {name}")
    return text


def variant_plan(block: int, step: int, phases: int, spec: int, cols: int, smem: int):
    """(w, d, s, window_pad, slide, max_tiles) of a variant, or None where
    one tile's rows do not fit: the wrapper's plan (ops/kernels/
    analysis_padded_fused.py) at other tile sizes."""
    w = math.gcd(step, block)
    d, s = block // w, step // w
    window, slide = d * phases + s * (spec - 1), s * spec
    box_rows = next(b for b in range(min(slide, 256), 0, -1) if slide % b == 0)
    window_pad = -(-window // box_rows) * box_rows
    buf_rows = (smem - 128) // (cols * 8)
    if w % cols or window_pad > buf_rows:
        return None
    return w, d, s, window_pad, slide, 1 + (buf_rows - window_pad) // slide


def back_to_back_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(WINDOWS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fold_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from ska_pst_dsp_tpu_torch.entry import mid_round_trip
    from ska_pst_dsp_tpu_torch.ops.analysis import padded_fold
    from ska_pst_dsp_tpu_torch.ops.kernels import SMEM_LIMIT, _build, stream_of

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    model = mid_round_trip(dev)
    step, f2d_rev = model.step, model.f2d_rev
    phases, block = f2d_rev.shape
    x = torch.randn((2, 4_587_520), dtype=torch.complex64, device=dev)
    nblocks = x.shape[1] // step
    ref = padded_fold(x, f2d_rev, step)
    scale = float(ref.abs().max())
    g = torch.empty_like(ref)
    text = (_build.CSRC / "analysis_padded_fused.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        for spec, cols, threads in VARIANTS:
            stem = os.path.join(tmp, f"fold_{spec}_{cols}_{threads}")
            with open(stem + ".cu", "w") as f:
                f.write(variant_source(text, spec, cols, threads))
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                   "-o", stem + ".so", stem + ".cu"]
            res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)
            name = f"K={spec} C={cols} threads={threads}"
            if res.returncode:
                print(f"[fold] {name}: does not build: {res.stdout.strip()[-300:]}",
                      flush=True)
                continue
            use = _build.parse_ptxas("// source: v.cu\n" + res.stdout)["v"]
            kern = next(v for k, v in use.items() if k.startswith("padded_fold_kernel<25"))
            lib = ctypes.CDLL(stem + ".so")
            lib.padded_fold_launch.argtypes = _build.SIGNATURES["padded_fold_launch"]
            lib.padded_fold_launch.restype = ctypes.c_int
            p = variant_plan(block, step, phases, spec, cols, SMEM_LIMIT)
            if p is None:
                print(f"[fold] {name}: one tile's rows do not fit in shared memory",
                      flush=True)
                continue
            w, d, s, window_pad, slide, max_tiles = p
            for tiles in range(1, max_tiles + 1):
                def call(tiles=tiles):
                    _build.check(lib.padded_fold_launch(
                        x.data_ptr(), g.data_ptr(), f2d_rev.data_ptr(), 2, x.shape[1],
                        x.stride(0), nblocks, block, w, d, s, phases, tiles,
                        SMEM_LIMIT, stream_of(x)), name)

                g.zero_()
                call()
                err = float((g - ref).abs().max()) / scale
                if not err <= TOL:
                    print(f"[fold] {name} tiles={tiles}: max|err|/scale {err:.3g} > {TOL}",
                          flush=True)
                    return 1
                staged = (window_pad + slide * (tiles - 1)) / (slide * tiles)
                print(f"[fold] {name} tiles={tiles}: "
                      f"{back_to_back_ms(torch, call):.4f} ms back to back, input staged "
                      f"{staged:.2f}x, max|err|/scale {err:.3g}, {kern['registers']} "
                      f"registers, spills {kern['spill_stores']} B ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
