"""The ``pst`` kind: an SKA-Low PST node timing a pulsar.

The node receives LowCBF's PST beam: for every coarse channel its
``kept_channels`` fine channels (fftshifted, so in monotonic frequency
order), both polarisations, laid out channel-major (n_pol, coarse *
kept, T) as LowCBF's stage stores them. One seeded stream of complex
fine-channel noise, replayed from a buffer of ``buffer_samples`` fine
samples a channel on the card, is handed over ``block`` samples a channel
at a time to the program's ``TwoStageInverseFilterBank`` (the
configuration's LowCBF stage, ``kept_channels`` a slab, its state carried),
which inverts each coarse channel back to its band and coherently
dedisperses it at the configuration's ``dm``, each at its own centre
frequency (``first_coarse_centre_mhz``, then ``coarse_bw_mhz`` apart), inside
the inversion. Its output is the (n_pol, coarse channels, n) reconstruction,
placed in the stream's output by the running count.

The check holds each run of ``blocks_per_sample`` consecutive requests to
the kind's plain reference (``references/pst.py``) on a stretch of the
stream that starts one inversion block before the first compared one. The
blocks are the reference's: each discards the taper's overlap and the
widest chirp's reach a side (its ``overlap``), so a program that keeps
another stretch of each frame puts its samples in the wrong place. The
kind counts the inversion's work by :mod:`pstbench.roofline`'s rule.
"""

from __future__ import annotations

import torch

from pstbench import generator, noise, roofline, system
from pstbench.reference import geometry


class Pst(generator.Stream):
    def __init__(self, params, cfg, filt, seed, device):
        super().__init__(params, cfg, filt, seed, device)
        self.kept = cfg["kept_channels"]
        self.coarse = cfg["coarse_channels"]
        #: the geometry of one coarse channel's slab: the inversion of its
        #: kept channels, at the reference's dedispersing discard
        self.slab = geometry({**cfg, "channels": self.kept, "analysis": "polyphase_analysis",
                              "input_overlap": generator.load("references", "pst").overlap(cfg)})

    def setup(self) -> None:
        from ska_pst_dsp_tpu_torch.models.two_stage import TwoStageInverseFilterBank
        from ska_pst_dsp_tpu_torch.ops.dedispersion import Dedispersion

        cfg = self.cfg
        self.block = int(self.params["block"])
        self.n_buf = int(self.params["buffer_samples"])
        if self.n_buf % self.block:
            raise ValueError("buffer_samples must be a whole number of blocks")
        self.group = int(self.params["blocks_per_sample"])
        stage = system.PortConfig(cfg, self.filt)
        stage.kept_channels = self.kept
        self.inv = TwoStageInverseFilterBank(
            stage, nch2=self.kept, device=self.device,
            dedispersion=Dedispersion(cfg["dm"], cfg["first_coarse_centre_mhz"],
                                      cfg["coarse_bw_mhz"]))
        self.states = [self.inv.init_state()]
        self.samples_per_request = self.n_pol * self.coarse * self.kept * self.block
        self.buf = noise.complex_noise((self.n_pol, self.coarse * self.kept, self.n_buf),
                                       self.seed, 0, self.device)
        self.emitted = 0

    def request(self, i, tr):
        a = (i * self.block) % self.n_buf
        with tr.span("issue"):
            self.states[0], z = self.inv.execute(self.states[0],
                                                 self.buf[:, :, a:a + self.block])
        with tr.span("wait"):
            generator._sync(self.device)
        self.emitted += z.shape[-1]
        return z

    def input(self, start: int, n: int) -> torch.Tensor:
        """Fine samples [start, start + n) of every channel: the buffer
        replayed."""
        idx = torch.arange(start, start + n, device=self.device) % self.n_buf
        return self.buf[:, :, idx]

    def expected(self, a, b, ref):
        """The stream's output samples [a, b) of every coarse channel, from
        the reference's one-shot inversion of a stretch of the input that
        starts a whole inversion block before block ``a // out_keep`` (or
        at the stream's start); none where the run is empty."""
        s = self.slab
        if b <= a:
            return self.buf.new_zeros((self.n_pol, self.coarse, 0))
        first, last = a // s.out_keep, -(-b // s.out_keep)
        b0 = max(0, first - 1)
        out = ref.inversion(self.input(b0 * s.keep, (last - b0) * s.keep + 2 * s.overlap))
        o0 = b0 * s.out_keep
        return out[..., a - o0:b - o0]

    def pairs(self, records, ref):
        """A pair for each run of contiguous output, cut into runs of at
        most ``blocks_per_sample`` requests. The reference's outputs are
        handed back in host memory: a sample's is up to 5.7 GB in float64,
        and the kept outputs and two precisions of every sample's reference
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
        return generator.load("references", "pst").Pst(self.cfg, self.filt, device, precision)

    def least_seconds(self, samples, device_name):
        """The inversion's FFT-optimal flops with the chirp's product (6 a
        point), and 8 B each complex64 fine sample read and each output
        sample written, over ``samples`` complex fine samples. The chirp
        table's bytes are not counted: a kernel may compute its phases."""
        s = self.slab
        blocks = samples / (s.n_chan * s.keep)  # inversion blocks over the samples
        flops = blocks * (s.n_chan * roofline.fft_flops(s.L) + 6.0 * s.n_chan * s.fn_width
                          + roofline.fft_flops(s.n_out_fft) + 6.0 * s.n_out_fft)
        return roofline.seconds(flops, 8.0 * (samples + blocks * s.out_keep), device_name)

    def free_program(self):
        del self.inv, self.states


KIND = Pst
