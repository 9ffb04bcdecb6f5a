"""The ``cascade`` kind: one seeded stream through SKA-Low's PST chain.

A request hands over the next ``block`` samples of each polarisation of one
stream, replayed from a seeded buffer of ``buffer_samples`` on the card,
to the program's ``TwoStageFilterBank`` (stage 1 the configuration's top
level, stage 2 its ``stage2`` group: the LowCBF firmware filterbank,
``kept_channels`` kept) and then ``TwoStageInverseFilterBank`` (each coarse
channel's ``kept_channels`` channels inverted, oversampled), both states
carried, as ``sgcht --two_stage --invert`` runs them. Its output is the
(n_pol, channels, n) reconstruction of every coarse channel, placed in the
stream's output by the running count.

The check holds each run of ``blocks_per_sample`` consecutive requests to
the kind's plain reference (``references/cascade.py``) on a stretch of the
stream that starts a whole number of inversion blocks in (hop 216 of stage
1 x hop 192 of stage 2 x the inversion's keep of 160, so the derotations
and the blocks line up) and one block before the first compared one, so
that the reference's start (no history before it, and LowCBF's first-call
pad of zeros) has left the compared samples. The kind counts the chain's
work by :mod:`pstbench.roofline`'s rule.
"""

from __future__ import annotations

import torch

from pstbench import design, generator, noise, roofline, system
from pstbench.reference import geometry


class Cascade(generator.Stream):
    def __init__(self, params, cfg, filt, seed, device):
        from pstbench import run

        super().__init__(params, cfg, filt, seed, device)
        c2 = cfg["stage2"]
        self.filt2 = design.prototype_filter(c2, run.ROOT)
        #: the geometry of one coarse channel's slab: stage 2's inversion on
        #: its kept channels
        self.slab = geometry({**c2, "channels": c2["kept_channels"],
                              "analysis": "polyphase_analysis"})
        nu, de = design.os_parts(c2)
        #: stage 2's hop, in stage-1 spectra
        self.step2 = c2["channels"] * de // nu

    def setup(self) -> None:
        from ska_pst_dsp_tpu_torch.models.two_stage import (
            TwoStageFilterBank, TwoStageInverseFilterBank,
        )

        self.block = int(self.params["block"])
        self.n_buf = int(self.params["buffer_samples"])
        if self.n_buf % self.block:
            raise ValueError("buffer_samples must be a whole number of blocks")
        self.group = int(self.params["blocks_per_sample"])
        self.samples_per_request = self.n_pol * self.block
        self.buf = noise.complex_noise((self.n_pol, self.n_buf), self.seed, 0, self.device)
        c2 = self.cfg["stage2"]
        stage1 = system.PortConfig(self.cfg, self.filt)
        stage2 = system.PortConfig(c2, self.filt2)
        stage2.kept_channels = c2["kept_channels"]
        self.fb = TwoStageFilterBank(stage1, stage2, device=self.device)
        self.inv = TwoStageInverseFilterBank(stage1, stage2, nch2=c2["kept_channels"],
                                             device=self.device)
        self.states = [self.fb.init_state(), self.inv.init_state()]
        self.emitted = 0

    def expected(self, a, b, ref):
        """The stream's output samples [a, b) of every coarse channel, from
        the reference's one-shot chain of a stretch of the input that
        starts a whole inversion block before block ``a // out_keep``
        (or at the stream's start); none where the run is empty."""
        s = self.slab
        if b <= a:
            return self.buf.new_zeros((self.n_pol, self.cfg["channels"], 0))
        first, last = a // s.out_keep, -(-b // s.out_keep)
        b0 = max(0, first - 1)
        spectra2 = (last - b0) * s.keep + 2 * s.overlap
        t1 = spectra2 * self.step2 + ref.nfilt - ref.pad
        n_in = t1 * self.g.step + self.g.fl
        out = ref.cascade(self.input(b0 * s.keep * self.step2 * self.g.step, n_in))
        o0 = b0 * s.out_keep
        return out[..., a - o0:b - o0]

    def pairs(self, records, ref):
        """A pair for each run of contiguous output, cut into runs of at
        most ``blocks_per_sample`` requests, so that a reference's stretch
        fits on the card however the kept samples fall. The reference's
        outputs are handed back in host memory: a sample's is 4.3 GB, and
        the kept outputs and two precisions of every sample's reference
        (the control's) do not fit on the card together."""
        out = []
        for run in generator._runs(records):
            for i in range(0, len(run), self.group):
                part = run[i:i + self.group]
                got = torch.cat([z for _, z in part], dim=-1)
                a = part[0][0]
                out.append((got, self.expected(a, a + got.shape[-1], ref).cpu()))
        return out

    def reference(self, device, precision="fp64"):
        return generator.load("references", "cascade").Cascade(
            self.cfg, self.filt, self.filt2, device, precision)

    def least_seconds(self, samples, device_name):
        """The three steps' FFT-optimal flops, and 8 B each complex64 input
        sample read and each output sample written, over ``samples``
        complex input samples."""
        g, s, c2 = self.g, self.slab, self.cfg["stage2"]
        coarse = g.n_chan / g.step  # stage-1 samples of all coarse channels an input sample
        blocks = coarse / self.step2 / s.keep  # inversion blocks an input sample
        flops = ((4.0 * g.fl + roofline.fft_flops(g.n_chan)) / g.step
                 + coarse / self.step2 * (4.0 * c2["fir_filter_taps"]
                                          + roofline.fft_flops(c2["channels"]))
                 + blocks * (s.n_chan * roofline.fft_flops(s.L) + 6.0 * s.n_chan * s.fn_width
                             + roofline.fft_flops(s.n_out_fft)))
        return roofline.seconds(flops * samples, 8.0 * samples * (1 + blocks * s.out_keep),
                                device_name)


KIND = Cascade
