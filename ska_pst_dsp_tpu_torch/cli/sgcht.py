"""sgcht — Signal Generator, CHannelizer & Tester.

The port's counterpart of :mod:`ska_pst_dsp_tpu.cli.sgcht`, the equivalent
of the reference's main Matlab driver (sgcht.m:1-586): generate a test
signal (or read one from file), optionally channelize it (one or two
stages), optionally invert, then either test fidelity in-stream or write a
DADA file whose name encodes the processing chain.

    python -m ska_pst_dsp_tpu_torch.cli.sgcht --signal complex_sinusoid \
        --cfg low --invert --test [--device cpu]

Keyword surface, output-file naming (sgcht.m:104-222), header surgery
(:316-354) and the block loop (:504-575) follow the reference; block sizes
are configurable (reference defaults: 64 Msample blocks two-stage /
64 ksample otherwise). The streaming modules run on ``--device`` (default
the card, where they launch the CUDA kernels): a block stays there from the
generator through the filterbanks and inverses, and is copied to the host
only for the tester and the DADA write.
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
from ..models import signals, testers
from ..models.streaming import FilterBank, InverseFilterBank
from ..models.two_stage import TwoStageFilterBank, TwoStageInverseFilterBank
from ..utils import geometry
from ..utils.config import load_config, CONFIG_DIR
from ..utils.rational import Rational

module_logger = logging.getLogger(__name__)

PRODUCTS_DIR = os.path.abspath(os.path.join(CONFIG_DIR, "..", "products"))


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sgcht", description="Signal Generator, CHannelizer & Tester"
    )
    p.add_argument("--cfg", default="", help="analysis filterbank configuration")
    p.add_argument("--cfg2", default="", help="second-stage configuration")
    p.add_argument("--skip", action="store_true", help="skip the analysis step")
    p.add_argument("--signal", default="square_wave",
                   choices=["square_wave", "frequency_comb", "frequency_wedge",
                            "complex_sinusoid", "temporal_impulse"])
    p.add_argument("--input", default="", help="load signal from DADA file")
    p.add_argument("--two_stage", action="store_true")
    p.add_argument("--invert", action="store_true")
    p.add_argument("--combine", type=int, default=1)
    p.add_argument("--critical", action="store_true")
    p.add_argument("--single", action="store_true")
    p.add_argument("--comb", default="", choices=["", "coarse", "fine"])
    p.add_argument("--test", action="store_true")
    p.add_argument("--f_taper", default="", help="spectral taper name")
    p.add_argument("--nbit", type=int, default=32, choices=[8, 16, 32])
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--output_nchan", type=int, default=0)
    p.add_argument("--periods", type=int, default=0)
    p.add_argument("--rndInput", action="store_true")
    p.add_argument("--rmsInput", type=float, default=0.0)
    p.add_argument("--rndOutput", action="store_true")
    p.add_argument("--rmsOutput", type=float, default=0.0)
    p.add_argument("--offset", type=int, default=20000,
                   help="temporal_impulse sample offset")
    p.add_argument("--frequency", type=float, default=0.0,
                   help="complex_sinusoid frequency in cycles/sample "
                        "(overrides the header TONEFREQ)")
    p.add_argument("--blocks", type=int, default=0,
                   help="override number of blocks")
    p.add_argument("--blocksz", type=int, default=0,
                   help="override block size in samples")
    p.add_argument("--output_dir", default=PRODUCTS_DIR)
    p.add_argument("--device", default="cuda",
                   help="torch device the streaming modules run on (default: the card)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def output_file_name(a) -> str:
    """Encode the processing chain in the file name (sgcht.m:104-222)."""
    name = a.signal
    if a.comb:
        name += "_" + a.comb
    if a.cfg:
        name += "_" + a.cfg
    if a.cfg2:
        name += "_" + a.cfg2
    if a.two_stage or a.cfg2:
        name += "_two_stage"
    if a.critical:
        name += "_critical"
    if a.invert:
        name += "_inverted"
    if a.f_taper:
        name += "_" + a.f_taper
    if a.combine > 1:
        name += f"_{a.combine}"
    if a.single:
        name += "_single"
    if a.nbit != 32:
        name += f"_{a.nbit}bit"
    if a.rndInput or a.rmsInput > 0:
        name += "_rndIn"
    if a.rmsInput > 0:
        name += f"_rmsIn={a.rmsInput}"
    if a.rndOutput or a.rmsOutput > 0:
        name += "_rndOut"
    if a.rmsOutput > 0:
        name += f"_rmsOut={a.rmsOutput}"
    return name + ".dada"


class ImpulseUndefined(ValueError):
    """Impulse testing after a critical inversion: the band-limited
    (chomped) impulse violates the +-1-sample criterion by construction,
    so the test is undefined for the combination, not failed."""


def _validate(a):
    if a.comb and not a.cfg:
        raise ValueError("cannot specify comb spacing without cfg")
    if a.comb and a.signal != "frequency_comb":
        raise ValueError("comb spacing requires signal=frequency_comb")
    if (a.two_stage or a.cfg2) and not a.cfg:
        raise ValueError("cannot have two stages without cfg")
    if a.critical and not (a.two_stage or a.cfg2):
        raise ValueError("critical output implemented only for two-stage")
    if a.invert and not a.cfg:
        raise ValueError("cannot invert without cfg")
    if a.f_taper and not a.invert:
        raise ValueError("spectral taper requires inversion")
    if a.combine > 1 and not ((a.two_stage or a.cfg2) and a.invert):
        raise ValueError("combine requires two-stage analysis and inversion")
    if a.single and not (a.two_stage or a.cfg2):
        raise ValueError("single-channel output implemented only for two-stage")


def run(argv=None) -> int:
    a = create_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if a.verbose else logging.INFO)
    _validate(a)
    two_stage = a.two_stage or bool(a.cfg2)

    signal = "from_file" if a.input else a.signal
    dev = torch.device(a.device)

    # ---- header template ------------------------------------------------
    if signal == "from_file":
        header = dada.read_header(a.input)
        gen = signals.DADAReadGenerator(a.input, device=dev)
        header["INSTRUMENT"] = "dspsr"
    else:
        with open(os.path.join(CONFIG_DIR, f"{signal}_header.json")) as f:
            header = {k: str(v) for k, v in json.load(f).items()}

    tsamp = float(header.get("TSAMP", 1.0))
    n_chan = 1
    config = config2 = None
    filterbank = inverse = None
    filt_coeff = None
    os1 = os2 = Rational(1, 1)
    level = 0

    fb_kwargs = dict(
        rnd_input=a.rndInput, rms_input=a.rmsInput,
        rnd_output=a.rndOutput, rms_output=a.rmsOutput, device=dev,
    )

    if a.cfg:
        config = load_config(a.cfg)
        filt_coeff = config.load_fir_filter_coeff()
        n_chan = config.channels
        os1 = os2 = config.os_factor
        level = 0
        if not a.skip:
            if two_stage:
                config2 = load_config(a.cfg2) if a.cfg2 else config
                os2 = config2.os_factor
                filterbank = TwoStageFilterBank(
                    config, config2, critical=a.critical, single=a.single,
                    **fb_kwargs,
                )
                level = 2
            else:
                filterbank = FilterBank(config, **fb_kwargs)
                level = 1

        pfb_nchan = n_chan
        if a.critical and level == 2:
            pfb_nchan = os1.normalize(n_chan)

        if a.invert:
            if two_stage:
                config2 = load_config(a.cfg2) if a.cfg2 else config
                nch2_inv = pfb_nchan
                if (not a.critical
                        and config2.analysis_function
                        == "polyphase_analysis_lowcbf"):
                    # LowCBF stage 2 emits its KEPT (216) channels
                    nch2_inv = config2.kept_channels or config2.channels
                elif a.critical:
                    nch2_inv = config2.os_factor.normalize(config2.channels)
                inverse = TwoStageInverseFilterBank(
                    config, config2, single=a.single, combine=a.combine,
                    nch2=nch2_inv, device=dev,
                )
            else:
                inverse = InverseFilterBank(config, device=dev)
            if a.f_taper:
                inverse = inverse.frequency_taper(a.f_taper)
            level -= 1

        if level != 0:
            # header surgery (sgcht.m:316-354)
            new_tsamp = tsamp
            last_os = os2 if level == 2 else os1
            if level > 0:
                if a.critical and level == 1:
                    new_tsamp = new_tsamp * n_chan
                else:
                    new_tsamp = (new_tsamp * os1.de / os1.nu) * n_chan
                    if level == 2:
                        new_tsamp = (new_tsamp * os2.de / os2.nu) * n_chan
            else:
                new_tsamp = (new_tsamp * last_os.nu / last_os.de) / pfb_nchan
            new_tsamp /= a.combine

            header["NBIT"] = str(a.nbit)
            header["TSAMP"] = str(new_tsamp)
            header["PFB_DC_CHAN"] = "1"
            header["NSTAGE"] = str(level)
            header["NCHAN_PFB_0"] = str(n_chan)
            if config.kept_channels:
                pfb_nchan = config.kept_channels
            header["PFB_NCHAN"] = str(pfb_nchan)
            header["OS_FACTOR"] = str(last_os)
            header = dada.add_fir_filter_to_header(header, filt_coeff, last_os)

    # ---- generator + tester ---------------------------------------------
    tester = None
    if signal == "from_file":
        pass
    elif signal == "square_wave":
        calfreq = float(header.get("CALFREQ", 1.0))
        period = int(round(1e6 / (calfreq * tsamp)))
        gen = signals.SquareWave(period=period, device=dev)
        if a.test:
            raise ValueError("testing not implemented for square_wave")
    elif signal == "frequency_wedge":
        gen = signals.FrequencyWedge(device=dev)
        if a.test:
            raise ValueError("testing not implemented for frequency_wedge")
    elif signal == "frequency_comb":
        nharmonic = 32
        amplitudes = np.linspace(1.0, np.sqrt(2.0), nharmonic)
        fmin = -0.5 + 1.0 / (nharmonic * 4)
        fmax = fmin + (nharmonic - 1.0) / nharmonic
        if a.comb == "coarse":
            fmin, fmax = fmin / n_chan, fmax / n_chan
        elif a.comb == "fine":
            fmin, fmax = fmin / n_chan**2, fmax / n_chan**2
        elif n_chan > 1:
            nch = n_chan**2 if two_stage else n_chan
            if a.invert:
                nch //= n_chan
            if nch > 1:
                fmin += 1.0 / (nch * 4)
                fmax += 1.0 / (nch * 4)
        frequencies = np.linspace(fmin, fmax, nharmonic)
        gen = signals.FrequencyComb(tuple(amplitudes), tuple(frequencies), device=dev)
        if a.test:
            tester = testers.TestFrequencyComb(
                frequencies, os_factor=os1, two_stage=two_stage,
                invert=a.invert, critical=a.critical,
            )
    elif signal == "complex_sinusoid":
        calfreq = float(header.get("TONEFREQ", 250000.0))
        freq = a.frequency if a.frequency else (calfreq * tsamp) / 1e6
        gen = signals.PureTone(frequency=freq, device=dev)
        if a.test:
            from fractions import Fraction

            lc1 = (config is not None and config.analysis_function
                   == "polyphase_analysis_lowcbf")
            lc2 = two_stage and (
                (config2 or config).analysis_function
                == "polyphase_analysis_lowcbf"
            )
            stages = []
            lowcbf_flags = []
            if level >= 1:
                stages.append((n_chan, os1))
                lowcbf_flags.append(lc1)
            if level >= 2:
                stages.append((config2.channels, os2))
                lowcbf_flags.append(lc2)
            resample = None
            db_max = -60.0
            check_bin, guard = True, 0
            if a.invert and lc1 and not two_stage:
                # LowCBF inversion reconstructs only the kept sub-band:
                # output rate KEPT/n of the input, band starting at
                # fftshifted channel KEPT_LO — the tone maps to
                # f*(n/KEPT) + (n/2 - KEPT_LO)/KEPT
                from ..ops.lowcbf import KEPT, KEPT_LO

                resample = (
                    Fraction(n_chan, KEPT),
                    Fraction(n_chan // 2 - KEPT_LO, KEPT),
                )
            monotonic_inv = False
            # channelized (non-inverted) streams: exclude the filter
            # startup transient from the purity measurement — the tone's
            # turn-on convolved with the prototype is a property of the
            # test signal's finite support, not of the filterbank (with it
            # excluded the mid channelized tone measures ~-150 dB; with it
            # included, ~-50 dB of transient skirt masks everything)
            skip = 0
            if level >= 1:
                def _fl(cfgo, coeff_len):
                    if (cfgo.analysis_function
                            == "polyphase_analysis_lowcbf"):
                        from ..ops import lowcbf as _lc

                        return _lc.NFILT + _lc.FIRST_CALL_PAD
                    if (cfgo.analysis_function
                            == "polyphase_analysis_padded"):
                        return geometry.padded_filter_length(
                            coeff_len, cfgo.channels
                        )
                    return coeff_len

                step1 = geometry.analysis_step(n_chan, os1)
                t = -(-_fl(config, len(filt_coeff)) // step1) + 2
                if level >= 2:
                    cfg2o = config2 or config
                    filt2_len = len(cfg2o.load_fir_filter_coeff())
                    step2 = geometry.analysis_step(cfg2o.channels, os2)
                    t = -(-(t + _fl(cfg2o, filt2_len)) // step2) + 2
                elif a.invert and two_stage:
                    # stage-2 round trip behind an inverted cascade: its
                    # analysis + synthesis transient, in coarse samples
                    cfg2o = config2 or config
                    filt2_len = len(cfg2o.load_fir_filter_coeff())
                    t += 2 * _fl(cfg2o, filt2_len)
                skip = t
            if a.invert and two_stage and lc2 and not a.critical:
                # stage-2 LowCBF round trip: the tested stream is the
                # stage-1 coarse channels, each carrying its band-subset
                # reconstruction at KEPT/n2 rate
                from ..ops.lowcbf import KEPT, KEPT_LO

                n2c = (config2 or config).channels
                stages = stages[:1]
                lowcbf_flags = lowcbf_flags[:1]
                resample = (
                    Fraction(n2c, KEPT),
                    Fraction(n2c // 2 - KEPT_LO, KEPT),
                )
            if a.invert and a.critical and two_stage and lc2:
                # monotonic (fftshifted, edge-chomped) LowCBF critical
                # inversion: channels assemble in given order (perm
                # identity), so the tester derives the output line
                # directly from (c1, c2, phi) — see
                # TestPureTone.monotonic_critical and divergences.rst
                monotonic_inv = True
                stages = [(n_chan, os1), ((config2 or config).channels, os2)]
                lowcbf_flags = [lc1, lc2]
                resample = None
            elif a.invert and a.critical and two_stage:
                # critical inversion emits at de/nu rate with the
                # half-fine-channel modulation (polyphase_synthesis.m:253-255
                # keeps each channel's band at its lower edge); its purity is
                # bounded by the chomp's hard band edges, not the -60 dB
                # requirement (which applies to the full Nyquist-spanning
                # inversion)
                nch2c = os2.normalize((config2 or config).channels)
                resample = (
                    Fraction(os2.nu, os2.de), Fraction(1, 2 * nch2c)
                )
                db_max = -40.0
            tester = testers.TestPureTone(
                frequency=gen.frequency, stages=stages,
                critical=(a.critical and level == 2) or monotonic_inv,
                resample=resample, db_max=db_max,
                check_bin=check_bin, guard=guard,
                # combine>1: the reordered slab's exact line position is
                # derived from combine_channel_permutation in the tester —
                # the bin check stays ON (round-2 loosened it to "one
                # dominant peak"; the mapping is deterministic)
                combine=a.combine if (a.invert and a.critical and two_stage)
                else 1,
                nch2_critical=(
                    os2.normalize((config2 or config).channels)
                    if (a.invert and a.critical and two_stage and not lc2)
                    else 0
                ),
                lowcbf_stages=tuple(lowcbf_flags),
                skip=skip,
                monotonic_critical=monotonic_inv,
            )
    elif signal == "temporal_impulse":
        gen = signals.Impulse(offset=a.offset, device=dev)
        if a.test and config is None:
            # raw stream, no channeliser (test_sgcht.m:5-9): the impulse
            # must sit exactly where it was generated
            tester = testers.TestImpulse(offset=gen.offset)
        elif a.test:
            output_overlap = (
                config.os_factor.normalize(config.input_overlap) * config.channels
            )
            fir_offset = config.fir_offset_direction * (filt_coeff.size // 2)
            filter_offset = output_overlap - 1 + config.kludge_offset
            if a.invert and a.critical and two_stage:
                raise ImpulseUndefined(
                    "impulse testing after critical inversion is undefined: "
                    "the band-limited (chomped) impulse violates the "
                    "+-1-sample criterion by construction"
                )
            lc1 = config.analysis_function == "polyphase_analysis_lowcbf"
            lc2 = two_stage and (
                (config2 or config).analysis_function
                == "polyphase_analysis_lowcbf"
            )
            if a.invert and (lc1 if not two_stage else lc2):
                # the LowCBF inversion reconstructs only the kept sub-band
                # (216/256) at a reduced rate; the band-truncated impulse
                # position/shape mapping is not modeled by this tester
                raise testers.NotModeled(
                    "impulse testing after LowCBF inversion is not modeled "
                    "(band-truncated kept-sub-band reconstruction)"
                )
            col = support = None
            if level >= 1:
                # expected peak column of the channelized stream (calibrated
                # in tests/test_streaming.py): the plain kernel's block k
                # spans [k*step, k*step+fl) so the peak sits where the filter
                # center crosses the impulse; the padded kernel has its group
                # delay removed already; the LowCBF kernel front-pads
                # FIRST_CALL_PAD samples, delaying every block by
                # FIRST_CALL_PAD/step columns.
                import math as _math

                from ..ops.lowcbf import FIRST_CALL_PAD as _LCPAD
                from ..utils import geometry as _geometry

                step1 = _geometry.analysis_step(n_chan, os1)
                fl1 = _geometry.padded_filter_length(filt_coeff.size, n_chan)
                if config.analysis_function == "polyphase_analysis_padded":
                    t1 = gen.offset / step1
                elif lc1:
                    t1 = (gen.offset + _LCPAD - fl1 / 2) / step1
                else:
                    t1 = (gen.offset - fl1 / 2) / step1
                support = fl1 // step1 + 2
                if level == 2:
                    filt2 = (config2 or config).load_fir_filter_coeff()
                    nch2 = (config2 or config).channels
                    step2 = _geometry.analysis_step(nch2, os2)
                    fl2 = _geometry.padded_filter_length(filt2.size, nch2)
                    support = support // step2 + fl2 // step2 + 2
                    pad2 = _LCPAD if lc2 else 0
                    t1 = (t1 + pad2 - fl2 / 2) / step2
                elif two_stage and a.invert:
                    # coarse channels after the stage-2 round trip: the
                    # inverted stream reproduces stage-1 advanced by the
                    # stage-2 total sample shift
                    cfg2 = config2 or config
                    filt2 = cfg2.load_fir_filter_coeff()
                    t1 -= _geometry.total_sample_shift(
                        cfg2.channels, os2, filt2.size, cfg2.input_overlap
                    )
                col = int(_math.floor(t1 + 0.5))
            tester = testers.TestImpulse(
                offset=gen.offset + fir_offset - filter_offset,
                chan_peak_col=col, chan_support=support or 0,
            )
    else:
        raise ValueError(f"unrecognized signal {signal}")

    # ---- block loop ------------------------------------------------------
    if two_stage:
        blocksz, blocks = 64 * 1024 * 1024, 2
    else:
        blocksz, blocks = 64 * 1024, 2 * 1024
        if signal == "frequency_comb":
            blocks = 128
    if a.cfg == "mid":
        blocksz *= 2
    if a.periods > 0 and hasattr(gen, "period"):
        blocks, blocksz = a.periods, gen.period
    if a.blocksz:
        blocksz = a.blocksz
    if a.blocks:
        blocks = a.blocks

    fb_state = filterbank.init_state() if filterbank is not None else None
    inv_state = inverse.init_state() if inverse is not None else None
    tester_state = tester.init_state() if tester is not None else None

    out_path = None
    out_created = False
    if not a.test:
        os.makedirs(a.output_dir, exist_ok=True)
        out_path = os.path.join(a.output_dir, output_file_name(a))

    from ..utils.profiling import StageTimer, trace

    # each stage ends with the device synchronised: its time holds its work
    timer = StageTimer(dev)
    current = 0
    for i in range(blocks):
        with trace():  # torch.profiler scope when SKA_PST_TRACE_DIR is set
            with timer.stage("generate", blocksz):
                x = gen.generate(current, blocksz)
            current += blocksz
            if x.shape[-1] == 0:
                break

            if n_chan > 1 and not a.skip and filterbank is not None:
                with timer.stage("channelize", x.shape[-1]):
                    fb_state, x = filterbank.execute(fb_state, x)
            if a.invert and inverse is not None:
                with timer.stage("invert", x.shape[-1]):
                    inv_state, x = inverse.execute(inv_state, x)
        if x.shape[-1] == 0:
            continue

        if a.test:
            with timer.stage("test", x.shape[-1]):
                tester_state, result = tester.test(tester_state, x)
            if result != 0:
                module_logger.error("sgcht test failed: %s", tester_state.detail)
                return -1
        else:
            with timer.stage("copy", x.shape[-1]):
                to_write = x.cpu().numpy()
            if a.scale != 1.0:
                to_write = a.scale * to_write
            to_write = to_write.astype(np.complex64)
            if a.output_nchan > 0:
                to_write = to_write[:, : a.output_nchan, :]
            with timer.stage("write", to_write.shape[-1]):
                if not out_created:
                    dada.save(out_path, to_write, header,
                              nbit=a.nbit if a.nbit != 32 else None)
                    out_created = True
                else:
                    dada.append(out_path, to_write)

    timer.report(module_logger.debug if not a.verbose else None)
    if not a.test:
        module_logger.info("sgcht: wrote %s", out_path)
    elif tester is not None and (
        tester_state.current == 0
        or (isinstance(tester, testers.TestPureTone)
            and tester_state.judged == 0)
    ):
        # a test run whose tester never saw a sample — or whose every
        # block fell inside the startup-transient skip — proves nothing;
        # the reference returns 0 here (vacuous pass); we refuse to
        module_logger.error(
            "sgcht: tester starved — nothing was judged (increase "
            "blocks/blocksz)"
        )
        return -2
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
