"""A traffic kind that comes in as new files: the one-shot analysis alone.

A sample of what a configuration of a new shape brings, which the
benchmark's tests copy beside the harness's own files. Each request
channelises ``samples`` per polarisation of one of ``windows`` seeded
inputs through the program's ``analysis_fused`` and hands back the
time-major spectra (n_pol, spectra, channels). The check holds them to the
kind's own plain reference (``references/analysis.py``), and the kind
counts its own work by :mod:`pstbench.roofline`'s rule.
"""

from __future__ import annotations

from typing import Dict

import torch

from pstbench import generator, roofline


class Analysis(generator.OneShot):
    def setup(self):
        from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import analysis_fused

        super().setup()
        rt = self.model
        self.model = lambda x: analysis_fused(x, rt.f2d, rt.ramp, rt.step)

    def pairs(self, records, ref):
        want: Dict[int, torch.Tensor] = {}
        out = []
        for w, got in records:
            if w not in want:
                want[w] = ref.analysis(self.x[w])
            out.append((got, want[w]))
        return out

    def reference(self, device, precision="fp64"):
        return generator.load("references", "analysis").Analysis(
            self.cfg, self.filt, device, precision)

    def least_seconds(self, samples, device_name):
        g = self.g
        flops = (4.0 * g.fl + roofline.fft_flops(g.n_chan)) / g.step * samples
        # complex64 in, and nu/de as many spectrum samples out
        return roofline.seconds(flops, 8.0 * samples * (1 + g.nu / g.de), device_name)


KIND = Analysis
