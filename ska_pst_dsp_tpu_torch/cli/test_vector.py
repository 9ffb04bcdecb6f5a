"""Requirement-verification DADA test-vector writer.

The port's copy of :mod:`ska_pst_dsp_tpu.cli.test_vector` (host numpy and
DADA: its files and ``expect`` JSON are the JAX package's, byte for byte),
the equivalent of the reference's test_vector.m:10-249: write DADA files with
temporal impulses or spectral tones placed per verification state using the
exact block-geometry offset math of the SKA-Low / SKA-Mid signal chains, so
downstream PFB + inversion runs land each feature at a predicted position.

    python -m ska_pst_dsp_tpu_torch.cli.test_vector --cbf low --domain temporal
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from ..io import dada
from ..utils.config import CONFIG_DIR

module_logger = logging.getLogger(__name__)

#: per-CBF geometry (test_vector.m:66-92)
CBF_PARAMS = {
    "low": dict(Nchan=256, Ttap=12, Qnum=32, Qden=27, Rnum=4, Rden=3,
                Nfft=1024, Tover=128, Nlost=0),
    "mid": dict(Nchan=4096, Ttap=28, Qnum=4, Qden=3, Rnum=8, Rden=7,
                Nfft=2048, Tover=252, Nlost=0),
}


def create_parser():
    p = argparse.ArgumentParser(
        prog="test_vector", description="requirement test-vector writer"
    )
    p.add_argument("--cbf", default="low", choices=sorted(CBF_PARAMS))
    p.add_argument("--domain", default="temporal",
                   choices=["temporal", "spectral"])
    p.add_argument("--nstate", type=int, default=8,
                   help="number of verification states (features) to place")
    p.add_argument("--nbit", type=int, default=32, choices=[8, 16, 32])
    p.add_argument("--nfft", type=int, default=0, help="override Nfft")
    p.add_argument("--header", default=os.path.join(CONFIG_DIR,
                                                    "default_header.json"))
    p.add_argument("--output", default="")
    p.add_argument("--output_dir", default="./")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def generate(cbf: str, domain: str, nstate: int = 8, nbit: int = 32,
             nfft_override: int = 0):
    """Return (data (1,1,T) complex64, expectations dict). Derivations follow
    test_vector.m:94-127 and the per-state placement at :174-249."""
    P = CBF_PARAMS[cbf]
    Nchan, Ttap = P["Nchan"], P["Ttap"]
    Qnum, Qden, Rnum, Rden = P["Qnum"], P["Qden"], P["Rnum"], P["Rden"]
    Nfft, Tover = (nfft_override or P["Nfft"]), P["Tover"]

    Ncritical = Nchan * Qden // Qnum     # critically sampled fine channels
    Tkeep = Nfft * Rden // Rnum          # kept bins per fine-channel FFT
    Tifft = Nchan * Tkeep                # coarse samples per backward FFT
    tifft = Ncritical * Tkeep            # backward FFT length (critical)
    Tstep = Nchan * Rden // Rnum         # coarse-sample stride per fine sample
    Tin = Nchan * Ttap
    Tskip = Tover * Tstep
    Tfft = Nfft * Tstep
    if Tfft != Tifft:
        raise ValueError(f"forward Tfft={Tfft} != inverse Tifft={Tifft}")
    Tlost = Tskip + P["Nlost"]

    ndat = Tifft - Tskip
    states = []
    if domain == "spectral":
        ndat *= 2
        nyq = -tifft // 2
        Nyq = -Tifft // 2
        tkeep = Tkeep * Qden // Qnum
        freq_step = round(tifft / (nstate - 1)) if nstate > 1 else 0

    blocks = []
    for istate in range(1, nstate + 1):
        file_offset = (istate - 1) * ndat
        data = np.zeros((1, 1, ndat), dtype=np.complex64)
        if domain == "temporal":
            offset = Tskip + Tstep + (istate + 1) * Tstep // nstate
            Ki = (file_offset + offset - Tlost) * Qden // Qnum
            data[0, 0, offset] = 1j
            states.append({"state": istate, "offset": int(offset),
                           "file_offset": int(file_offset), "Ki": int(Ki)})
        else:
            dfreq = (istate - 1) * freq_step
            if istate > 1:
                dfreq -= tkeep
            freq = (nyq + dfreq + tifft) % tifft
            Freq = (nyq + dfreq + Tifft) % Tifft
            f = Freq / Tifft
            t = np.arange(Tifft)
            data[0, 0, :Tifft] = np.exp(2j * np.pi * f * t)
            states.append({"state": istate, "freq": int(freq),
                           "Freq": int(Freq), "f": float(f),
                           "file_offset": int(file_offset)})
        blocks.append(data)

    Ntrail = Tskip + Tin
    blocks.append(np.zeros((1, 1, Ntrail), dtype=np.complex64))
    data = np.concatenate(blocks, axis=2)

    scale = {32: 1.0, 16: 2.0**14, 8: 2.0**6}[nbit]
    data = (data * scale).astype(np.complex64)

    Ttotal = nstate * ndat + Ntrail
    Tsecond = (Ttotal - Tin) // Tstep
    Nblock = (Tsecond - Tover) // (Nfft - Tover)
    tskip = Ncritical * Tover
    expect = {
        "cbf": cbf, "domain": domain, "nstate": nstate,
        "Ncritical": Ncritical, "Tkeep": Tkeep, "Tifft": Tifft,
        "tifft": tifft, "Tstep": Tstep, "Tskip": Tskip, "Tin": Tin,
        "Ttotal": int(Ttotal), "Tsecond": int(Tsecond),
        "inversion_blocks": int(Nblock),
        "inverted_samples": int(Nblock * (tifft - tskip)),
        "states": states,
    }
    return data, expect


def run(argv=None) -> int:
    a = create_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)
    data, expect = generate(a.cbf, a.domain, a.nstate, a.nbit, a.nfft)
    with open(a.header) as f:
        header = {k: str(v) for k, v in json.load(f).items()}
    os.makedirs(a.output_dir, exist_ok=True)
    name = a.output or f"test_vector.{a.cbf}.{a.domain}.dada"
    out_path = os.path.join(a.output_dir, name)
    dada.save(out_path, data, header, nbit=a.nbit if a.nbit != 32 else None)
    with open(out_path + ".expect.json", "w") as f:
        json.dump(expect, f, indent=2)
    module_logger.info(
        "test vector of %d samples written to %s (expect %d inverted samples)",
        expect["Ttotal"], out_path, expect["inverted_samples"],
    )
    return 0


def main():
    import sys

    sys.exit(run())


if __name__ == "__main__":
    main()
