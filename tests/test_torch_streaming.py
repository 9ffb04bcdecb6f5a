"""The port's streaming filterbanks, two-stage cascades, signal generators
and in-stream testers against the JAX package's, on the CPU.

The same numpy-seeded inputs go through the JAX class and the port's (the
kernels' plain versions, since the tensors lie on the CPU): streamed
analysis at 3e-6 * scale and streamed inversion at 3e-6 * scale
(tests/test_streaming.py:95-170), the cascades at 3e-5 * scale
(tests/test_two_stage.py), and each streamed output equal to the port's own
one-shot output. Deterministic generators equal JAX's sample for sample;
noisy ones (threefry tiles in JAX, torch generators here) are held to the
same statistics. Testers give the same verdicts and states on the same
arrays.
"""

import ast
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from ska_pst_dsp_tpu.models import signals as jax_signals
from ska_pst_dsp_tpu.models import streaming as jax_streaming
from ska_pst_dsp_tpu.models import testers as jax_testers
from ska_pst_dsp_tpu.models import two_stage as jax_two_stage
from ska_pst_dsp_tpu.utils.config import load_config as jax_load_config
from ska_pst_dsp_tpu_torch import models
from ska_pst_dsp_tpu_torch.io import dada
from ska_pst_dsp_tpu_torch.models import signals, streaming, testers, two_stage
from ska_pst_dsp_tpu_torch.models.round_trip import PaddedPFBRoundTrip, PFBRoundTrip
from ska_pst_dsp_tpu_torch.ops import synthesis as tsynth
from ska_pst_dsp_tpu_torch.ops.analysis import polyphase_analysis, polyphase_analysis_padded
from ska_pst_dsp_tpu_torch.ops.kernels import ifft_big, inversion_fused
from ska_pst_dsp_tpu_torch.ops.kernels import synthesis_fused as tsf
from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import fused_inversion
from ska_pst_dsp_tpu_torch.ops.lowcbf import polyphase_analysis_lowcbf
from ska_pst_dsp_tpu_torch.utils import geometry, profiling
from ska_pst_dsp_tpu_torch.utils.config import load_config
from ska_pst_dsp_tpu_torch.utils.rational import Rational

STREAM_TOL = 3e-6    # tests/test_streaming.py
CASCADE_TOL = 3e-5   # tests/test_two_stage.py
REPO = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class SmallConfig:
    """A config-shaped object both packages' classes read."""
    analysis_function: str
    channels: int
    os_factor: str
    input_fft_length: int
    input_overlap: int
    fir_filter_taps: int
    deripple: bool = True
    temporal_taper: str = "tukey"
    kept_channels: int = 0
    _filt: np.ndarray = None

    def load_fir_filter_coeff(self):
        return self._filt


def _filt(taps, block):
    n = np.arange(taps) - (taps - 1) / 2
    h = np.sinc(n / block) * np.hamming(taps)
    return (h / h.sum()).astype(np.float64)


def _cfg(analysis="polyphase_analysis", block=32, os="4/3", taps_pc=8, L=64, ov=8):
    taps = block * taps_pc + 1
    return SmallConfig(analysis, block, os, L, ov, taps, _filt=_filt(taps, block))


def _lowcbf_cfg():
    taps = np.random.default_rng(3).standard_normal(3072)
    return SmallConfig("polyphase_analysis_lowcbf", 256, "4/3", 256, 48, 3072,
                       kept_channels=216, _filt=taps)


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _stream_all(fb, x, chunks):
    """Feed x in chunks through fb (either package); the outputs joined."""
    state, outs, pos = fb.init_state(), [], 0
    for c in chunks:
        state, out = fb.execute(state, x[..., pos: pos + c])
        pos += c
        out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        if out.shape[-1]:
            outs.append(out)
    return np.concatenate(outs, axis=-1)


def _close(got, ref, tol):
    n = min(got.shape[-1], ref.shape[-1])
    assert n > 0 and got.shape[:-1] == ref.shape[:-1]
    np.testing.assert_allclose(got[..., :n], ref[..., :n], atol=tol * np.abs(ref).max(), rtol=0)


class TestFilterBank:
    @pytest.mark.parametrize("analysis,chunks", [
        ("polyphase_analysis", [4000, 4000]),
        ("polyphase_analysis", [1000, 3000, 2500, 1500]),
        ("polyphase_analysis", [1333, 4555, 2112]),
        ("polyphase_analysis_padded", [3000, 3000, 2000]),
        ("polyphase_analysis_padded", [1500, 3500, 3000]),
        ("polyphase_analysis_lowcbf", [20000, 20000, 20000]),
        ("polyphase_analysis_lowcbf", [7000, 30000, 23000]),
    ])
    def test_streamed_matches_jax_and_oneshot(self, analysis, chunks):
        if analysis == "polyphase_analysis_lowcbf":
            cfg = _lowcbf_cfg()
        elif analysis == "polyphase_analysis_padded":
            cfg = _cfg(analysis, block=56, os="8/7")
        else:
            cfg = _cfg()
        x = _noise((2, 1, sum(chunks)), 4)
        got = _stream_all(streaming.FilterBank(cfg, device="cpu"), x, chunks)
        ref = _stream_all(jax_streaming.FilterBank(cfg), x, chunks)
        assert got.shape == ref.shape
        _close(got, ref, STREAM_TOL)
        # the port's streamed output equals its one-shot output
        fn = {"polyphase_analysis": polyphase_analysis,
              "polyphase_analysis_padded": polyphase_analysis_padded}.get(analysis)
        if fn is None:
            one = polyphase_analysis_lowcbf(x, cfg._filt, first_call=True)
        else:
            one = fn(x, cfg._filt, cfg.channels, cfg.os_factor)
        _close(got, one.numpy(), 1e-6)

    def test_carried_state_matches_jax(self):
        cfg = _cfg("polyphase_analysis_padded", block=56, os="8/7")
        x = _noise((1, 1, 9000), 5)
        fb, jfb = streaming.FilterBank(cfg, device="cpu"), jax_streaming.FilterBank(cfg)
        s, js = fb.init_state(), jfb.init_state()
        for a, b in ((0, 2500), (2500, 2600), (2600, 9000)):
            s, _ = fb.execute(s, torch.as_tensor(x[:, :, a:b]))
            js, _ = jfb.execute(js, x[:, :, a:b])
            assert (s.base, s.emitted) == (js.base, js.emitted)
            np.testing.assert_array_equal(s.buffer.numpy(), js.buffer[:, 0])
        assert fb.chunk_spectra == jfb.chunk_spectra

    def test_rounding_matches_jax(self):
        cfg = _cfg()
        x = 30 * _noise((2, 1, 8000), 6)
        kw = dict(rnd_input=True, rnd_output=True)
        got = _stream_all(streaming.FilterBank(cfg, device="cpu", **kw), x, [4000, 4000])
        ref = _stream_all(jax_streaming.FilterBank(cfg, **kw), x, [4000, 4000])
        np.testing.assert_array_equal(got, ref)
        # rms scaling: the same scale up to float rounding, values within one
        for rms in (0.0, 7.5):
            a = streaming._round_rms(torch.as_tensor(x), rms).numpy()
            b = jax_streaming._round_rms(x, rms)
            assert np.abs(a - b).max() <= 1.0 and (a == b).mean() > 0.999

    def test_buffers_built_once(self):
        fb = streaming.FilterBank(_cfg(), device="cpu")
        names = {n for n, _ in fb.named_buffers()}
        assert names == {"f2d", "ramp"}
        assert models.FilterBank is streaming.FilterBank


class TestInverseFilterBank:
    @pytest.mark.parametrize("chunks,offset", [([600, 600], 0), ([123, 456, 621], 0),
                                               ([700, 500], 37)])
    def test_streamed_matches_jax_and_oneshot(self, chunks, offset):
        cfg = _cfg()
        x = _noise((1, cfg.channels, sum(chunks)), 5)
        got = _stream_all(streaming.InverseFilterBank(cfg, sample_offset=offset, device="cpu"),
                          x, chunks)
        ref = _stream_all(jax_streaming.InverseFilterBank(cfg, sample_offset=offset), x, chunks)
        assert got.shape == ref.shape
        _close(got, ref, STREAM_TOL)
        one = tsynth.polyphase_synthesis(
            x, cfg.input_fft_length, cfg.os_factor, input_overlap=cfg.input_overlap,
            deripple_coeff=cfg._filt, temporal_taper="tukey", sample_offset=offset).numpy()
        _close(got, one, 1e-6)

    @pytest.mark.parametrize("critical,combine,monotonic", [(True, 1, False), (True, 4, False),
                                                           (False, 1, True)])
    def test_modes_match_jax(self, critical, combine, monotonic):
        cfg = _cfg()
        n_chan = 24 * combine if critical else cfg.channels
        x = _noise((2, n_chan, 700), 7)
        kw = dict(critical=critical, combine=combine, monotonic=monotonic)
        inv = streaming.InverseFilterBank(cfg, device="cpu", **kw).frequency_taper("tukey")
        got = _stream_all(inv, x, [300, 400])
        ref = _stream_all(jax_streaming.InverseFilterBank(cfg, **kw).frequency_taper("tukey"),
                          x, [300, 400])
        _close(got, ref, STREAM_TOL)
        assert {n for n, _ in inv.named_buffers()} == {"t_taper", "dr", "perm", "elem"}

    def test_lowcbf_slabs_monotonic(self, monkeypatch):
        # 216-channel monotonic slabs (a lowpsi stage 2): no epilogue plan,
        # so the fused inversion takes each chunk whole and no composed
        # epilogue runs
        cfg = _lowcbf_cfg()
        x = _noise((2, 216, 600), 8)
        calls, fused = [], inversion_fused.inversion_fused
        monkeypatch.setattr(inversion_fused, "inversion_fused",
                            lambda *a, **k: calls.append(a[0].shape) or fused(*a, **k))
        before = fused_inversion.composed_epilogues
        got = _stream_all(streaming.InverseFilterBank(cfg, monotonic=True, device="cpu"),
                          x, [250, 350])
        ref = _stream_all(jax_streaming.InverseFilterBank(cfg, monotonic=True), x, [250, 350])
        _close(got, ref, STREAM_TOL)
        assert calls and all(shape[2] == 216 for shape in calls)
        assert fused_inversion.composed_epilogues == before


#: streams through the split input (a config, its channels, its stage's
#: arguments, the blocks, and the kinds of call among them: the first with
#: nothing held, one that consumes no chunk, one that consumes less than it
#: holds, one whose held samples are then a view of its block, one that
#: consumes a double chunk)
SPLIT_CASES = {
    "small": (_cfg, 32, {}, [112, 90, 90, 90, 90, 200, 30, 60, 150],
              {"first", "none", "short", "view", "double"}),
    "small_offset": (_cfg, 32, {"sample_offset": 37}, [112, 90, 90, 90, 90, 200, 30, 60, 150],
                     {"first", "short", "view", "double"}),
    # a whole-chunk cycle, as an SKA-Low PST node's: the held samples grow
    # by 128 a call until a call consumes two chunks
    "slab216_cycle": (_lowcbf_cfg, 216, {"monotonic": True}, [448] * 6,
                      {"first", "view", "double"}),
    "slab216_ragged": (_lowcbf_cfg, 216, {"monotonic": True},
                       [400, 200, 200, 100, 50, 60, 100, 300],
                       {"first", "none", "short", "view", "double"}),
}


class TestSplitInput:
    """InverseFilterBank hands its held samples and the new block to an
    inversion that reads two inputs (the plain versions here) as they lie:
    each call's output and carried state (held samples, consumed) are
    bitwise the concatenating path's (the stage with ``_reads_split``
    False), and ``carry_bytes`` grows only where the docstring says: by the
    held samples and the block where a call consumes no chunk, by the
    unconsumed held samples and the block where it consumes fewer than it
    holds, by nothing where its held samples are then a view of its block.
    ``inversion_fused_split`` counts launches: none on the CPU."""

    @staticmethod
    def _run(cfg, kw, x, chunks):
        inv = streaming.InverseFilterBank(cfg, device="cpu", plain=True, **kw)
        state, calls, pos = inv.init_state(), [], 0
        for c in chunks:
            before = profiling.counters()
            h = 0 if state.buffer is None else state.buffer.shape[-1]
            new, out = inv.execute(state, x[..., pos:pos + c])
            after = profiling.counters()
            calls.append({"out": out, "buffer": new.buffer, "consumed": new.consumed,
                          "h": h, "pos": pos, "n": c, "ate": new.consumed - state.consumed,
                          "first": state.buffer is None, "blocks": inv.chunk_blocks,
                          **{k: after[k] - before[k] for k in ("carry_bytes",
                                                               "inversion_fused_split")}})
            state, pos = new, pos + c
        return calls, inv

    @pytest.mark.parametrize("case", sorted(SPLIT_CASES))
    def test_split_equals_joined(self, case, monkeypatch):
        make, n_chan, kw, chunks, kinds = SPLIT_CASES[case]
        cfg = make()
        x = torch.as_tensor(_noise((2, n_chan, sum(chunks)), 9))
        split, inv = self._run(cfg, kw, x, chunks)
        monkeypatch.setattr(streaming.InverseFilterBank, "_reads_split", lambda self, n: False)
        joined, _ = self._run(cfg, kw, x, chunks)
        keep = inv.n_fft - 2 * inv.overlap
        per = 8 * 2 * n_chan  # complex64 bytes of a sample of every stream
        seen = set()
        for s, j in zip(split, joined):
            h, n, ate = s["h"], s["n"], s["ate"]
            assert torch.equal(s["out"], j["out"]) and (s["out"].shape[-1] > 0) == (ate > 0)
            assert torch.equal(s["buffer"], j["buffer"]) and s["consumed"] == j["consumed"]
            kind = ("first" if s["first"] else "none" if ate == 0
                    else "short" if ate < h else "view")
            seen |= {kind} | ({"double"} if ate >= 2 * s["blocks"] * keep else set())
            want = {"first": 0, "none": h + n, "short": h - ate + n, "view": 0}[kind]
            assert s["carry_bytes"] == per * want
            assert j["carry_bytes"] == (per * (h + n) if h else 0)
            assert s["inversion_fused_split"] == j["inversion_fused_split"] == 0
            if kind == "view":  # the held samples: the tail of the caller's block
                assert s["buffer"].data_ptr() == x[..., s["pos"] + ate - h:].data_ptr()
        assert seen == kinds

    def test_the_caller_keeps_its_block_until_the_next_call(self):
        # the contract of execute's docstring: where the consumed samples
        # cover the held ones, the held samples are a view of the caller's
        # block, so a block written to before the next call changes that
        # call's output (a caller that reuses its buffer hands over a copy)
        cfg = _cfg()
        x = torch.as_tensor(_noise((2, 32, 112 + 96 + 96), 9))
        outs = []
        for overwrite in (False, True):
            inv = streaming.InverseFilterBank(cfg, device="cpu", plain=True)
            blocks = [x[..., :112].clone(), x[..., 112:208].clone(), x[..., 208:].clone()]
            state = inv.init_state()
            state, _ = inv.execute(state, blocks[0])
            h = state.buffer.shape[-1]
            consumed = state.consumed
            state, _ = inv.execute(state, blocks[1])
            assert state.consumed - consumed >= h and state.buffer.shape[-1] > 0
            assert (state.buffer.untyped_storage().data_ptr()
                    == blocks[1].untyped_storage().data_ptr())
            if overwrite:
                blocks[1].zero_()
            outs.append(inv.execute(state, blocks[2])[1])
        assert outs[0].shape == outs[1].shape and outs[0].shape[-1] > 0
        assert not torch.equal(outs[0], outs[1])


class TestPipeline:
    def test_tone_through_streaming_chain(self):
        # tests/test_streaming.py:204-232 on the port, against JAX's chain
        cfg = _cfg(block=64, taps_pc=12, L=128, ov=24)
        outs = []
        for mk, gen in ((lambda c: (streaming.FilterBank(c, device="cpu"),
                                    streaming.InverseFilterBank(c, device="cpu")),
                         signals.PureTone(frequency=10.125 / 64, device="cpu")),
                        (lambda c: (jax_streaming.FilterBank(c),
                                    jax_streaming.InverseFilterBank(c)),
                         jax_signals.PureTone(frequency=10.125 / 64))):
            pipe = (streaming.StatefulPipeline if outs == [] else
                    jax_streaming.StatefulPipeline)(*mk(cfg))
            ys = [np.asarray(pipe.execute(gen.generate(i * 16384, 16384))) for i in range(6)]
            outs.append(np.concatenate([y for y in ys if y.shape[-1]], axis=2))
        _close(outs[0], outs[1], STREAM_TOL)


@pytest.fixture(scope="module")
def test32():
    c, jc = load_config("test32"), jax_load_config("test32")
    c.load_fir_filter_coeff()
    jc.load_fir_filter_coeff()
    return c, jc


def _tone(n, f=7 / 512, n_pol=2):
    x = np.exp(2j * np.pi * f * np.arange(n)).astype(np.complex64)
    return np.broadcast_to(x, (n_pol, n)).copy()[:, None, :]


class TestTwoStage:
    @pytest.mark.parametrize("kw", [{}, {"critical": True}, {"single": True}])
    def test_matches_jax(self, test32, kw):
        c, jc = test32
        x = _tone(120_000)
        _, got = two_stage.TwoStageFilterBank(c, device="cpu", **kw).execute(
            two_stage.TwoStageFilterBank(c, device="cpu", **kw).init_state(), x)
        jfb = jax_two_stage.TwoStageFilterBank(jc, **kw)
        _, ref = jfb.execute(jfb.init_state(), x)
        assert got.shape[:2] == ref.shape[:2]
        _close(got.numpy(), np.asarray(ref), CASCADE_TOL)

    def test_streamed_equals_oneshot(self, test32):
        c, _ = test32
        x = _tone(160_000)
        fb1 = two_stage.TwoStageFilterBank(c, device="cpu")
        streamed = _stream_all(fb1, x, [80_000, 80_000])
        fb2 = two_stage.TwoStageFilterBank(c, device="cpu")
        fb2.stage1.chunk_spectra = fb1.stage1.chunk_spectra
        fb2.stage2.chunk_spectra = fb1.stage2.chunk_spectra
        _, one = fb2.execute(fb2.init_state(), x)
        _close(streamed, one.numpy(), 1e-6)

    def test_lowcbf_stage2_edge_chomp(self):
        # a LowCBF stage 2 with the fftshift-aware chomp (216 -> 192 kept
        # channels about DC): a 4/3 stage 1 normalises 256 to 192
        c1 = _cfg(block=16, taps_pc=8)
        c2 = _lowcbf_cfg()
        x = _noise((1, 1, 80_000), 9)
        kw = dict(critical=True)
        fb = two_stage.TwoStageFilterBank(c1, c2, device="cpu", **kw)
        got = _stream_all(fb, x, [50_000, 30_000])
        ref = _stream_all(jax_two_stage.TwoStageFilterBank(c1, c2, **kw), x, [50_000, 30_000])
        assert got.shape[1] == 16 * 192 and fb.stage2_monotonic
        _close(got, ref, CASCADE_TOL)

    @pytest.mark.parametrize("kw,nch2", [({}, 32), ({"critical": True}, 24),
                                         ({"critical": True, "combine": 4}, 24)])
    def test_inverse_matches_jax(self, test32, kw, nch2):
        c, jc = test32
        x = _tone(700_000, f=9 / 1024)
        crit = kw.get("critical", False)
        fb = jax_two_stage.TwoStageFilterBank(jc, critical=crit)
        _, chan2 = fb.execute(fb.init_state(), x)
        chan2 = np.asarray(chan2)
        combine = kw.get("combine", 1)
        inv = two_stage.TwoStageInverseFilterBank(c, nch2=nch2, combine=combine, device="cpu")
        jinv = jax_two_stage.TwoStageInverseFilterBank(jc, nch2=nch2, combine=combine)
        got = _stream_all(inv, chan2, [chan2.shape[-1] // 2, chan2.shape[-1]])
        ref = _stream_all(jinv, chan2, [chan2.shape[-1] // 2, chan2.shape[-1]])
        assert got.shape == ref.shape and got.shape[1] == 32 // combine
        _close(got, ref, CASCADE_TOL)
        assert inv._critical == crit

    @pytest.mark.parametrize("nch2,combine", [(32, 4), (17, 1)])
    def test_inverse_rejects(self, test32, nch2, combine):
        with pytest.raises(ValueError):
            two_stage.TwoStageInverseFilterBank(test32[0], nch2=nch2, combine=combine,
                                                device="cpu").init_state()


class TestChannelMajorCascade:
    """The cascades' stages store channel-major, so their corner turns are
    views of the analyses' output. Output and state equal, bitwise, the
    same cascade over time-major stages (the earlier composition: transposed
    views of the analyses' spectra, LowCBF's kept bins gathered, and corner
    turns that copy), block after block."""

    @staticmethod
    def _time_major(c1, c2, **kw):
        fb = two_stage.TwoStageFilterBank(c1, c2, device="cpu", **kw)
        stage_kw = {k: v for k, v in kw.items() if k not in ("critical", "single")}
        fb.stage1 = streaming.FilterBank(c1, device="cpu", **stage_kw)
        fb.stage2 = streaming.FilterBank(c2, device="cpu", **stage_kw)
        return fb

    @pytest.mark.parametrize("stage2,kw", [
        ("lowcbf", {}), ("lowcbf", {"critical": True}), ("lowcbf", {"single": True}),
        ("lowcbf", {"rnd_output": True, "rms_output": 5.0}),
        ("plain", {}), ("plain", {"critical": True}),
    ])
    def test_equals_the_time_major_composition(self, stage2, kw):
        c1 = _cfg(block=16, taps_pc=8)
        c2 = _lowcbf_cfg() if stage2 == "lowcbf" else _cfg()
        x = torch.as_tensor(_noise((2, 1, 90_000), 13))
        new = two_stage.TwoStageFilterBank(c1, c2, device="cpu", **kw)
        old = self._time_major(c1, c2, **kw)
        assert new.stage1.channel_major and new.stage2.channel_major
        assert not (old.stage1.channel_major or old.stage2.channel_major)
        s_new, s_old, emitted = new.init_state(), old.init_state(), 0
        for a, b in ((0, 40_000), (40_000, 41_000), (41_000, 90_000)):
            s_new, y_new = new.execute(s_new, x[..., a:b])
            s_old, y_old = old.execute(s_old, x[..., a:b])
            assert torch.equal(y_new, y_old)
            emitted += y_new.shape[-1]
            for n, o in ((s_new.stage1, s_old.stage1), (s_new.stage2, s_old.stage2)):
                assert (n.base, n.emitted) == (o.base, o.emitted)
                assert torch.equal(n.buffer, o.buffer)
        assert emitted > 0

    def test_stage_outputs(self):
        # the stage hands back its store: channel-major and contiguous, or a
        # view of time-major spectra; LowCBF's holds its 216 kept bins
        x = torch.as_tensor(_noise((2, 1, 40_000), 14))
        for c, n_out in ((_cfg(block=16, taps_pc=8), 16), (_lowcbf_cfg(), 216)):
            cm = streaming.FilterBank(c, device="cpu", channel_major=True)
            tm = streaming.FilterBank(c, device="cpu")
            (_, y_cm), (_, y_tm) = cm.execute(cm.init_state(), x), tm.execute(tm.init_state(), x)
            assert y_cm.shape == y_tm.shape == (2, n_out, y_tm.shape[2]) and y_tm.shape[2] > 0
            assert y_cm.is_contiguous() and not y_tm.is_contiguous()
            assert torch.equal(y_cm, y_tm)
            assert cm.rows.dtype == torch.int32 and cm.rows.numel() == n_out


class TestSignals:
    @pytest.mark.parametrize("name", ["tone", "tone_far", "comb", "impulse"])
    def test_deterministic_equal_jax(self, name):
        port, ref, start = {
            "tone": (signals.PureTone(0.0371, device="cpu"), jax_signals.PureTone(0.0371), 0),
            "tone_far": (signals.PureTone(1 / 26.5, device="cpu"),
                         jax_signals.PureTone(1 / 26.5), 10 ** 9),
            "comb": (signals.FrequencyComb.standard(8, device="cpu"),
                     jax_signals.FrequencyComb.standard(8), 123),
            "impulse": (signals.Impulse(offset=500, noise=0, device="cpu"),
                        jax_signals.Impulse(offset=500, noise=0), 0),
        }[name]
        got = port.generate(start, 3000)
        assert got.dtype == torch.complex64 and got.shape == (1, 1, 3000)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.generate(start, 3000)))

    @pytest.mark.parametrize("gen", [
        signals.PureTone(0.0371, device="cpu"),
        signals.Impulse(offset=500, noise=1e-6, seed=1, device="cpu"),
        signals.SquareWave(period=26, seed=2, device="cpu"),
        signals.FrequencyComb.standard(8, device="cpu"),
        signals.FrequencyWedge(resolution=4096, seed=3, device="cpu"),
        signals.GaussianNoise(seed=4, n_pol=2, device="cpu"),
    ], ids=lambda g: type(g).__name__)
    def test_blocking_invariance(self, gen):
        whole = gen.generate(20_000, 40_000)
        parts = torch.cat([gen.generate(20_000, 1000), gen.generate(21_000, 17_000),
                           gen.generate(38_000, 22_000)], dim=2)
        assert torch.equal(whole, parts)
        s = gen.stream()
        assert torch.equal(torch.cat([s.generate(100), s.generate(250)], dim=2),
                           gen.generate(0, 350))

    def test_noise_statistics(self):
        # mean and variance per quadrature as JAX's threefry tiles give them
        n = 1 << 18
        for port, ref in ((signals.GaussianNoise(scale=2.0, seed=5, n_pol=2, device="cpu"),
                           jax_signals.GaussianNoise(scale=2.0, seed=5, n_pol=2)),
                          (signals.Impulse(noise=1e-3, seed=6, device="cpu"),
                           jax_signals.Impulse(noise=1e-3, seed=6))):
            a, b = port.generate(0, n).numpy(), np.asarray(ref.generate(0, n))
            assert a.shape == b.shape and a.dtype == b.dtype
            for v in (a, b):
                for q in (v.real, v.imag):
                    sd = np.sqrt(q.var())
                    assert abs(q.mean()) < 5 * sd / np.sqrt(q.size)
                assert v.real.var() == pytest.approx(b.real.var(), rel=0.02)
                assert v.imag.var() == pytest.approx(b.imag.var(), rel=0.02)
            if a.shape[0] > 1:  # polarizations are independent
                assert not np.array_equal(a[0], a[-1])

    def test_square_wave_statistics(self):
        t = np.arange(100_000)
        on = (t % 100) < 50
        for g in (signals.SquareWave(period=100, on_amp=4.0, off_amp=0.25, seed=7, device="cpu"),
                  jax_signals.SquareWave(period=100, on_amp=4.0, off_amp=0.25, seed=7)):
            x = np.asarray(g.generate(0, 100_000))[0, 0]
            p_on, p_off = np.mean(np.abs(x[on]) ** 2), np.mean(np.abs(x[~on]) ** 2)
            assert p_on == pytest.approx(4.0, rel=0.05) and p_off == pytest.approx(0.25, rel=0.05)
        x = signals.SquareWave(period=100, on_amp=4.0, seed=7, device="cpu").generate(0, 1000)
        assert not x[0, 0, ~torch.as_tensor(on[:1000])].abs().any()

    def test_wedge_slope(self):
        # the power spectrum of a segment rises linearly from its middle
        # (fftshifted linspace): both packages' fitted slopes agree
        res = 8192
        slopes = []
        for g in (signals.FrequencyWedge(resolution=res, seed=8, device="cpu"),
                  jax_signals.FrequencyWedge(resolution=res, seed=8)):
            x = np.asarray(g.generate(0, 16 * res))[0, 0].reshape(16, res)
            p = np.fft.fftshift((np.abs(np.fft.fft(x, axis=1)) ** 2).mean(0))
            slopes.append(np.polyfit(np.linspace(0, 1, res), p, 1))
        (a1, b1), (a2, b2) = slopes
        assert a1 == pytest.approx(a2, rel=0.05) and abs(b1) < 0.05 * a1

    @pytest.mark.parametrize("name", ["square_wave", "complex_sinusoid", "temporal_impulse",
                                      "frequency_comb", "frequency_wedge", "noise"])
    def test_make_generator(self, name):
        hdr = {"TSAMP": "1.08", "CALFREQ": "10", "TONEFREQ": "250000"}
        got = signals.make_generator(name, hdr, device="cpu")
        ref = jax_signals.make_generator(name, hdr)
        assert type(got).__name__ == type(ref).__name__
        fields = {f.name for f in dataclasses.fields(ref)}
        assert {k: getattr(got, k) for k in fields} == dataclasses.asdict(ref)

    def test_dada_read_generator(self, tmp_path):
        data = _noise((2, 4, 320), 9)
        path = str(tmp_path / "lc.dada")
        dada.save_lowcbf(path, data, {})
        g = signals.DADAReadGenerator(path, device="cpu")
        ref = jax_signals.DADAReadGenerator(path)
        assert (g.n_pol, g.n_chan) == (ref.n_pol, ref.n_chan)
        np.testing.assert_array_equal(g.generate(64, 128).numpy(), ref.generate(64, 128))


def _tester_cases():
    """(name, tester kwargs, input array): arrays the two packages'
    TestPureTone judge alike."""
    t = np.arange(8192)

    def tone(f, n_chan=1, chan=0, dirt=0.0):
        x = np.full((2, n_chan, t.size), 1e-9, np.complex64)
        x[:, chan] = np.exp(2j * np.pi * f * t) + dirt * np.exp(2j * np.pi * 0.3 * t)
        return x

    return [
        ("clean", dict(frequency=0.125), tone(0.125)),
        ("dirty", dict(frequency=0.125), tone(0.125, dirt=0.01)),
        ("wrong_bin", dict(frequency=0.125), tone(0.25)),
        ("band_swap", dict(frequency=0.125), tone(0.625)),
        ("guarded", dict(frequency=0.1, check_bin=False, guard=3), tone(0.1003)),
        ("skip", dict(frequency=0.125, skip=9000), tone(0.125)),
        ("channelized", dict(frequency=5.25 / 32, stages=[(32, "4/3")]),
         tone(0.25 * 0.75, 32, 5)),
        ("wrong_chan", dict(frequency=5.25 / 32, stages=[(32, "4/3")]), tone(0.1875, 32, 6)),
        ("critical", dict(frequency=13.1 / 32, stages=[(32, "4/3")], critical=True),
         tone(0.075, 24, 11)),
        ("lowcbf", dict(frequency=37.25 / 256, stages=[(256, "4/3")], lowcbf_stages=(True,)),
         tone(0.6875, 216, 145)),
        ("resample", dict(frequency=0.1, resample=(Fraction(4, 3), Fraction(1, 48))),
         tone(float(Fraction(1, 10) * Fraction(4, 3) + Fraction(1, 48)))),
        ("combine", dict(frequency=9 / 1024, stages=[(32, "4/3"), (32, "4/3")],
                         resample=(Fraction(4, 3), Fraction(1, 48)), combine=4,
                         nch2_critical=24), tone(0.3, 8, 0)),
        ("monotonic", dict(frequency=37.25 / 256, stages=[(256, "4/3"), (256, "4/3")],
                           lowcbf_stages=(False, True), critical=True,
                           monotonic_critical=True, combine=16), tone(0.4, 13, 2)),
    ]


class TestTesters:
    @pytest.mark.parametrize("name,kw,x", _tester_cases(), ids=lambda v: v if
                             isinstance(v, str) else "")
    def test_pure_tone_same_verdicts(self, name, kw, x):
        jkw = {**kw, "stages": [(n, o) for n, o in kw.get("stages", [])]}
        port, ref = testers.TestPureTone(**kw), jax_testers.TestPureTone(**jkw)
        ps, pr = port.test(port.init_state(), torch.as_tensor(x))
        js, jr = ref.test(ref.init_state(), x)
        assert (pr, dataclasses.asdict(ps)) == (jr, dataclasses.asdict(js))

    def test_truncated_slab_is_not_modeled(self):
        # lowpsi's monotonic critical inversion, combine 16: 216 coarse
        # channels make 13 slabs and drop channels 208-215; a tone there
        # raises where the JAX tester judges a stream without the tone
        kw = dict(frequency=(210 + 0.3) / 256, stages=[(256, "4/3"), (256, "4/3")],
                  lowcbf_stages=(False, True), critical=True, monotonic_critical=True,
                  combine=16)
        x = _noise((1, 13, 4096), 10)
        with pytest.raises(ValueError, match="truncation"):
            testers.TestPureTone(**kw).test(testers.TesterState(), x)
        assert jax_testers.TestPureTone(**kw).test(jax_testers.TesterState(), x)[1] == -1

    @pytest.mark.parametrize("case", ["raw_pass", "raw_leak", "across", "chan_pass", "chan_col",
                                      "chan_leak"])
    def test_impulse_same_verdicts(self, case):
        raw = np.full((1, 1, 4096), 1e-8, np.complex64)
        raw[0, 0, 1000] = 1.0
        chan = np.full((2, 8, 600), 1e-9, np.complex64)
        chan[:, :, 298:303] = 1.0
        kw, arrays = {
            "raw_pass": ({"offset": 1000}, [raw]),
            "raw_leak": ({"offset": 1000}, [raw + 0.1 * (np.arange(4096) == 2000)]),
            "across": ({"offset": 1500}, [raw[:, :, :1000], raw[:, :, 500:1500]]),
            "chan_pass": ({"offset": 0, "chan_peak_col": 300, "chan_support": 5}, [chan]),
            "chan_col": ({"offset": 0, "chan_peak_col": 200, "chan_support": 5}, [chan]),
            "chan_leak": ({"offset": 0, "chan_peak_col": 300, "chan_support": 1}, [chan]),
        }[case]
        port, ref = testers.TestImpulse(**kw), jax_testers.TestImpulse(**kw)
        ps, js = port.init_state(), ref.init_state()
        for a in arrays:
            ps, pr = port.test(ps, torch.as_tensor(a.astype(np.complex64)))
            js, jr = ref.test(js, a.astype(np.complex64))
            assert (pr, dataclasses.asdict(ps)) == (jr, dataclasses.asdict(js))

    @pytest.mark.parametrize("kw", [{}, {"two_stage": True, "invert": True}])
    def test_comb_and_phase_average(self, kw):
        comb = signals.FrequencyComb.standard(8, device="cpu")
        x = comb.generate(0, 8192)
        for k in ({}, {"os_factor": "4/3", **kw}):
            port = testers.TestFrequencyComb(comb.frequencies, **k)
            ref = jax_testers.TestFrequencyComb(comb.frequencies, **k)
            ps, pr = port.test(port.init_state(), x)
            js, jr = ref.test(ref.init_state(), x.numpy())
            assert (pr, dataclasses.asdict(ps)) == (jr, dataclasses.asdict(js))
        pa, jpa = testers.PhaseAverage(1 / 64, nbin=64), jax_testers.PhaseAverage(1 / 64, nbin=64)
        s, js = pa.init_state(), jpa.init_state()
        for a, b in ((0, 3000), (3000, 6400)):
            s, js = pa.average(s, x[:, :, a:b]), jpa.average(js, x[:, :, a:b].numpy())
        np.testing.assert_array_equal(s.result, js.result)
        np.testing.assert_array_equal(s.hits, js.hits)
        assert testers.critical_chomp_index(13, 32, Rational(4, 3)) == \
            jax_testers.critical_chomp_index(13, 32, jax_two_stage.Rational(4, 3))


class TestDispatch:
    @pytest.mark.parametrize("n_chan,critical,combine,kernel,epilogue", [
        (256, False, 1, "fused", "cluster"),    # the oversampled low cascade's slabs
        (192, True, 1, "composed", "composed"),  # critical, no combine: 36864 points
        (216, False, 1, "fused", "composed"),   # the lowpsi slabs' 41472 points
        (3072, True, 16, "pair", "pair"),       # critical combine 16: 589824 points
    ])
    def test_cascade_epilogues(self, n_chan, critical, combine, kernel, epilogue,
                               monkeypatch):
        # the kernel fused_inversion runs a slab's inversion on, seen at the
        # wrappers it calls, and the epilogue plan of the slab's length (what
        # a bare epilogue_dispatch, the sharded inversion's, runs)
        os_f = Rational(4, 3)
        g = geometry.SynthesisGeometry(n_chan, 256, 48, os_f)
        n, lo = g.output_fft_length, g.output_overlap
        ran = []

        def spy(which, wrapped):
            def fn(*a, **k):
                ran.append(which)
                return wrapped(*a, **k)
            return fn

        monkeypatch.setattr(inversion_fused, "inversion_fused",
                            spy("fused", inversion_fused.inversion_fused))
        for which, name in (("cluster", "fused_big_ifft"), ("pair", "fused_big_ifft_oc")):
            monkeypatch.setattr(tsf, name, spy(which, getattr(tsf, name)))
        c = tsynth.synthesis_constants(n_chan, 256, os_f, 48)
        args = [torch.as_tensor(c[k]) for k in ("t_taper", "dr", "perm")]
        x = torch.as_tensor(_noise((1, 96 + g.input_keep, n_chan), 12))
        composed = fused_inversion.composed_epilogues
        fused_inversion(x, *args, None, g, spans_nyquist=True)
        ran += ["composed"] * (fused_inversion.composed_epilogues - composed)
        assert ran == [kernel] and tsf.epilogue_plan(n, lo)[0] == epilogue
        if kernel == "pair":
            # the JAX split (3 * 384) * 512 needs a 1152 = 9 * 128-point inner
            # transform the kernel has no split for; 1536 * 384 it has
            assert ifft_big.plan_big_ifft(n, lo) == (3, 384, 512)
            assert not ifft_big.takes(1152, 512)
            assert tsf.epilogue_plan(n, lo) == ("pair", 1536, 384)

    @pytest.mark.parametrize("name", ["mid", "mid_external"])
    def test_pair_split_keeps_the_plan(self, name):
        # the plan's pair split at mid and mid_external is plan_big_ifft's p*q x n1
        cfg = load_config(name)
        g = geometry.SynthesisGeometry(cfg.channels, cfg.input_fft_length, cfg.input_overlap,
                                       cfg.os_factor)
        p, q, n1 = ifft_big.plan_big_ifft(g.output_fft_length, g.output_overlap)
        assert tsf.epilogue_plan(g.output_fft_length, g.output_overlap) == ("pair", p * q, n1)

    def test_composed_counter(self):
        os_f = Rational(4, 3)
        x = torch.as_tensor(_noise((1, 700, 192), 11))
        c = tsynth.synthesis_constants(192, 256, os_f, 48, spans_nyquist=False)
        args = [torch.as_tensor(c[k]) for k in ("t_taper", "dr", "perm")]
        g = geometry.SynthesisGeometry(192, 256, 48, os_f)
        before = fused_inversion.composed_epilogues
        out = fused_inversion(x, *args, None, g, spans_nyquist=False)
        assert fused_inversion.composed_epilogues == before + 1
        ref = tsynth.inversion_core(x, *args, None, g, spans_nyquist=False)
        assert torch.equal(out, ref)


NEW_MODULES = ["ops.lowcbf", "ops.dedispersion", "io.lowcbf", "models.streaming",
               "models.two_stage", "models.signals", "models.testers"]


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in [
    *(REPO / "ska_pst_dsp_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    if "_build" not in p.parts))
def test_no_import_of_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax."""
    for node in ast.walk(ast.parse((REPO / path).read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
        assert not [m for m in names if m == "jax" or m.startswith("jax.")], path


def test_new_modules_import_no_jax():
    """Importing the slice's modules and streaming a small LowCBF chain
    leaves jax and the JAX package out of sys.modules; importing the
    models package alone loads none of its modules."""
    code = (
        "import sys, json, torch\n"
        "import ska_pst_dsp_tpu_torch.models as m\n"
        "lazy = sorted(k for k in sys.modules if k.startswith('ska_pst_dsp_tpu_torch.models.'))\n"
        + "".join(f"import ska_pst_dsp_tpu_torch.{name}\n" for name in NEW_MODULES)
        + "from ska_pst_dsp_tpu_torch.models import FilterBank, GaussianNoise\n"
        "from ska_pst_dsp_tpu_torch.utils.config import load_config\n"
        "fb = FilterBank(load_config('lowpsi'), device='cpu')\n"
        "s, y = fb.execute(fb.init_state(), GaussianNoise(device='cpu').generate(0, 6000))\n"
        "def named(p): return sorted(k for k in sys.modules if k == p or k.startswith(p + '.'))\n"
        "print(json.dumps({'jax': named('jax'), 'pkg': named('ska_pst_dsp_tpu'), 'lazy': lazy,"
        " 'shape': list(y.shape)}))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"jax": [], "pkg": [], "lazy": [], "shape": [1, 216, 20]}


@pytest.mark.parametrize("obj", [
    streaming.FilterBank, streaming.InverseFilterBank, two_stage.TwoStageFilterBank,
    two_stage.TwoStageInverseFilterBank, signals.PureTone, signals.Impulse, signals.SquareWave,
    signals.FrequencyWedge, signals.GaussianNoise, signals.DADAReadGenerator,
    signals.FrequencyComb.standard, PFBRoundTrip.from_filter, PaddedPFBRoundTrip.from_filter,
], ids=lambda o: o.__qualname__)
def test_default_device_is_the_card(obj):
    assert inspect.signature(obj).parameters["device"].default == "cuda"
    if obj is PFBRoundTrip.from_filter and not torch.cuda.is_available():
        # built without a device, the module's state goes to the card
        with pytest.raises((RuntimeError, AssertionError)):
            PFBRoundTrip.from_filter(np.ones(3073), 256, "4/3", 256, 48)
