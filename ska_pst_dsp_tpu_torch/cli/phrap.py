"""phrap — PHase-Resolved Average Profile.

The port's counterpart of :mod:`ska_pst_dsp_tpu.cli.phrap`, the equivalent
of the reference's phrap.m:1-98: fold a periodic signal (from a DADA file or
a generated square wave, made on ``--device``, default the card) at CALFREQ
with the streaming PhaseAverage and write/plot the profile.

    python -m ska_pst_dsp_tpu_torch.cli.phrap --input square_wave.dada
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

from ..io import dada
from ..models import signals
from ..models.testers import PhaseAverage
from ..utils.config import CONFIG_DIR

module_logger = logging.getLogger(__name__)


def create_parser():
    p = argparse.ArgumentParser(prog="phrap",
                                description="phase-resolved folding")
    p.add_argument("--signal", default="square_wave")
    p.add_argument("--input", default="", help="fold a DADA file")
    p.add_argument("--nbin", type=int, default=256)
    p.add_argument("--blocks", type=int, default=64)
    p.add_argument("--blocksz", type=int, default=65536)
    p.add_argument("--display", action="store_true", help="save a PNG plot")
    p.add_argument("--output", default="", help="profile output (.npz)")
    p.add_argument("--device", default="cuda",
                   help="torch device the signal is made or read onto (default: the card)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def run(argv=None) -> int:
    a = create_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)

    if a.input:
        header = dada.read_header(a.input)
        gen = signals.DADAReadGenerator(a.input, device=a.device)
    else:
        with open(os.path.join(CONFIG_DIR, f"{a.signal}_header.json")) as f:
            header = {k: str(v) for k, v in json.load(f).items()}
        gen = signals.make_generator(a.signal, header, device=a.device)

    tsamp = float(header.get("TSAMP", 1.0))
    calfreq = float(header.get("CALFREQ", 1.0))
    pha = PhaseAverage(frequency=calfreq * tsamp * 1e-6, nbin=a.nbin)
    state = pha.init_state()

    pos = 0
    for i in range(a.blocks):
        x = gen.generate(pos, a.blocksz)
        pos += a.blocksz
        if x.shape[-1] == 0:
            break
        state = pha.average(state, torch.abs(x) ** 2)

    profile = state.result.real / np.maximum(state.hits, 1)
    module_logger.info(
        "phrap: folded %d samples into %d bins; profile max/min = %.3f/%.3f",
        state.current, a.nbin, profile.max(), profile.min(),
    )
    out = a.output or "phrap_profile.npz"
    np.savez(out, profile=profile, hits=state.hits,
             frequency=pha.frequency, nbin=a.nbin)
    if a.display:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(np.arange(a.nbin) / a.nbin, profile[0, 0])
        ax.set_xlabel("pulse phase")
        ax.set_ylabel("mean power")
        fig.savefig(os.path.splitext(out)[0] + ".png")
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
