"""The port's spans and counters (``utils/profiling.py``), on the CPU.

* With no profiler recording, :func:`span` hands back one shared null
  context and a round trip never calls ``record_function`` or the fast
  RecordFunction.
* Under a CPU ``torch.profiler.profile`` the low round trip, a reduced
  SKA-Mid round trip whose epilogue takes the out-of-core route and a
  ``FilterBank`` -> ``InverseFilterBank`` stream emit their ``pst:`` spans,
  each nested in the span above it in its layer; ``dispatch`` ends before
  the epilogue it chose starts, and SKA-Low's inversion (the one-shot round
  trip and the stream) is the fused wrapper alone, with no dispatch.
* Outputs are bitwise the same with the profiler on and off.
* ``carry_bytes`` counts the bytes of every carry's ``torch.cat`` output,
  reckoned here from the sizes of the carried buffers and the blocks: in
  the low stream the analysis's alone, since the inversion reads its held
  samples and each block where they lie.
* :func:`counters` holds every wrapper's launches, the analysis's
  channel-major launches, the fused inversion's launches on two inputs,
  the composed epilogues, the carry's bytes and the cascades' corner-turn
  bytes.
* A cascade (a 16-channel stage 1 into the LowCBF firmware filterbank,
  then each coarse channel's inversion, oversampled and critical) emits
  ``two_stage.filterbank`` and ``two_stage.inverse_filterbank`` around its
  stages' spans and ``corner_turn`` in those; in ``inversion`` the
  oversampled slabs' ``kernel.inversion_fused``, the critical slabs'
  ``composed_epilogue`` after their ``dispatch``; ``corner_turn_bytes``
  grows by nothing where every reshape is a view (both stages store
  channel-major), and by the bytes of the output where a critical
  cascade's chomp leaves it strided.
* On the card (marked ``cuda``; this module imports neither JAX nor the
  JAX package, so it runs there with ``--noconftest``): the low and mid
  main paths and the low stream emit the same spans, the out-of-core
  pair's two kernels among mid's, one ``kernel.<name>`` span for each
  launch its wrapper counts; so does SKA-Low's PST cascade (sps into
  lowpsi), whose inversion is the fused kernel with no composed
  epilogue, whose two analyses are channel-major launches and whose
  corner turns copy nothing.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ska_pst_dsp_tpu_torch.design import fir
from ska_pst_dsp_tpu_torch.entry import (
    L, N_CHAN, OS_FACTOR, OVERLAP, TAPS_PER_CHAN, low_round_trip, mid_round_trip,
)
from ska_pst_dsp_tpu_torch.models import streaming, two_stage
from ska_pst_dsp_tpu_torch.models.round_trip import PaddedPFBRoundTrip, PFBRoundTrip
from ska_pst_dsp_tpu_torch.ops.kernels import synthesis_fused as tsf
from ska_pst_dsp_tpu_torch.ops.kernels import wrappers
from ska_pst_dsp_tpu_torch.utils import geometry, profiling
from ska_pst_dsp_tpu_torch.utils.config import load_config
from ska_pst_dsp_tpu_torch.utils.rational import Rational

#: a reduced SKA-Mid slice: 1024 channels at 8/7, L 512 / overlap 128, so
#: N = 458752 = 7 * 128 * 512 and the epilogue takes the out-of-core pair
MID_CHAN, MID_OS, MID_L, MID_OV = 1024, Rational(8, 7), 512, 128
#: low's block of sgcht's stream, and the blocks the test stream runs
BLOCK, BLOCKS = 65536, 4

#: each span's parent among the program's spans (None: the outermost), for
#: every span each case emits on the CPU (the plain versions run inside
#: the wrappers' spans; the out-of-core pair's two kernels only on a card)
NESTING = {
    # SKA-Low's inversion is one fused wrapper, chosen with no dispatch
    "low": {"forward": None, "kernel.analysis_fused": "forward", "inversion": "forward",
            "kernel.inversion_fused": "inversion"},
    "mid_pair": {"forward": None, "kernel.analysis_padded_fused": "forward",
                 "kernel.chan_dft_fused": "forward", "inversion": "forward",
                 "kernel.synthesis_fused": "inversion", "dispatch": "inversion"},
    "stream": {"filterbank": None, "inverse_filterbank": None, "carry": None,
               "kernel.analysis_fused": "filterbank", "inversion": "inverse_filterbank",
               "kernel.inversion_fused": "inversion"},
}
#: on the card mid's main path runs the out-of-core pair's two kernels
CARD_NESTING = {
    "low": NESTING["low"], "stream": NESTING["stream"],
    "mid": {**NESTING["mid_pair"], "kernel.ifft_big_inner": "inversion",
            "kernel.ifft_big_outer": "inversion"},
}
#: the carries' parents: the stage whose execute joins them
CARRY_PARENTS = {"filterbank", "inverse_filterbank"}
#: each span a cascade's forward and inverse emit -> its possible parents
CASCADE_NESTING = {
    "two_stage.filterbank": {None}, "two_stage.inverse_filterbank": {None},
    "filterbank": {"two_stage.filterbank"},
    "corner_turn": {"two_stage.filterbank", "two_stage.inverse_filterbank"},
    "kernel.analysis_fused": {"filterbank"},
    "inverse_filterbank": {"two_stage.inverse_filterbank"},
    "inversion": {"inverse_filterbank"},
    "kernel.synthesis_fused": {"inversion"}, "dispatch": {"inversion"},
    "composed_epilogue": {"inversion"}, "kernel.inversion_fused": {"inversion"},
}
#: the inversion's spans of each cascade (by ``critical``): the oversampled
#: slabs' 216 channels are the fused kernel's, the critical slabs' 192 run
#: the frontend and the composed epilogue the dispatch picks
CASCADE_INVERSION = {False: {"kernel.inversion_fused"},
                     True: {"kernel.synthesis_fused", "dispatch", "composed_epilogue"}}
#: the CPU cascade's stage 1: 16 channels at OS 4/3 (hop 12), 12 taps a
#: channel; its input gives each coarse channel one inversion block (256
#: LowCBF spectra behind the first call's pad of 1536, at hop 192)
CASCADE_CHAN = 16
CASCADE_N = (256 * 192 + 3072 - 1536) * 12 + 13 * CASCADE_CHAN


@dataclasses.dataclass
class LowConfig:
    """The SKA-Low configuration as the streaming stages read it."""
    _filt: np.ndarray
    analysis_function: str = "polyphase_analysis"
    channels: int = N_CHAN
    os_factor: Rational = OS_FACTOR
    input_fft_length: int = L
    input_overlap: int = OVERLAP
    deripple: bool = True
    temporal_taper: str = "tukey"
    kept_channels: int = None

    def load_fir_filter_coeff(self):
        return self._filt


def _noise(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(shape, generator=g), torch.randn(shape, generator=g))


@pytest.fixture(scope="module")
def low_filt():
    return fir.design_pfb_fir_filter(N_CHAN, OS_FACTOR, TAPS_PER_CHAN)


@pytest.fixture(scope="module")
def cases(low_filt):
    """name -> a fresh run of the case: () -> its outputs."""
    mid_filt = fir.design_pfb_fir_filter(MID_CHAN, MID_OS, 4)
    mid_geom = geometry.SynthesisGeometry(MID_CHAN, MID_L, MID_OV, MID_OS)
    mid_step = geometry.analysis_step(MID_CHAN, MID_OS)
    x_low = _noise((2, 2 ** 16), 1)
    x_mid = _noise((2, (2 * MID_OV + mid_geom.input_keep) * mid_step), 2)
    x_stream = _noise((2, BLOCKS * BLOCK), 3)

    def low():
        m = PFBRoundTrip.from_filter(low_filt, N_CHAN, OS_FACTOR, L, OVERLAP, device="cpu",
                                     temporal_taper="tukey")
        return [m(x_low)]

    def mid_pair():
        m = PaddedPFBRoundTrip.from_filter(mid_filt, MID_CHAN, MID_OS, MID_L, MID_OV,
                                           device="cpu")
        return [m(x_mid)]

    def stream():
        return run_stream(low_filt, x_stream)

    return {"low": low, "mid_pair": mid_pair, "stream": stream}


def run_stream(filt, x, shapes=None, device="cpu"):
    """``x`` through a fresh FilterBank then InverseFilterBank in blocks of
    BLOCK; before each call that has a carried buffer, (the stage's span,
    the buffer's shape, the block's shape) is appended to ``shapes``."""
    cfg = LowConfig(filt)
    fb = streaming.FilterBank(cfg, device=device)
    inv = streaming.InverseFilterBank(cfg, device=device)
    s_fb, s_inv = fb.init_state(), inv.init_state()
    outs = []
    for a in range(0, x.shape[-1], BLOCK):
        block = x[:, a:a + BLOCK]
        if shapes is not None and s_fb.buffer is not None:
            shapes.append(("filterbank", s_fb.buffer.shape, block.shape))
        s_fb, y = fb.execute(s_fb, block)
        if shapes is not None and s_inv.buffer is not None:
            shapes.append(("inverse_filterbank", s_inv.buffer.shape, y.shape))
        s_inv, z = inv.execute(s_inv, y)
        outs += [y, z]
    return outs


def run_cascade(configs, x, device="cpu", **kw):
    """``x`` through a fresh cascade (``kw``: ``critical`` or ``single``)
    and its inverse, one call each; returns (forward's output, the
    stage-1 spectra it emitted, inverse's output)."""
    stage1, stage2 = configs
    os2 = Rational.coerce(stage2.os_factor)
    nch2 = os2.normalize(stage2.channels) if kw.get("critical") else stage2.kept_channels
    fb = two_stage.TwoStageFilterBank(stage1, stage2, device=device, **kw)
    inv = two_stage.TwoStageInverseFilterBank(stage1, stage2, nch2=nch2, device=device,
                                              single=kw.get("single", False))
    state, y = fb.execute(fb.init_state(), x)
    _, z = inv.execute(inv.init_state(), y)
    return y, state.stage1.emitted, z


@pytest.fixture(scope="module")
def cascade_configs():
    """(the CPU cascade's stage 1, the LowCBF stage 2 of lowpsi)."""
    lowpsi = load_config("lowpsi")
    filt = fir.design_pfb_fir_filter(CASCADE_CHAN, OS_FACTOR, TAPS_PER_CHAN)
    return LowConfig(filt, channels=CASCADE_CHAN), lowpsi


def _program_spans(prof):
    """[(name, parent program span's name or None, start, end)] of the
    ``pst:`` annotations of a profile on the host (with the card's activity
    recorded an annotation that holds kernels shows on the card's timeline
    too)."""
    out = []
    for ev in prof.events():
        if not ev.name.startswith(profiling.PREFIX) or ev.device_type != DeviceType.CPU:
            continue
        parent = ev.cpu_parent
        while parent is not None and not parent.name.startswith(profiling.PREFIX):
            parent = parent.cpu_parent
        out.append((ev.name[len(profiling.PREFIX):],
                    None if parent is None else parent.name[len(profiling.PREFIX):],
                    ev.time_range.start, ev.time_range.end))
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _program_spans(prof)


def test_span_off_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("forward") is profiling.span("dispatch")
    assert isinstance(profiling.span("carry"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("carry"):
            pass
    assert [e.name for e in prof.events()] == ["pst:carry"]


def test_no_profiler_no_record_function(cases, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    out = cases["low"]()
    assert out[0].shape[0] == 2 and torch.isfinite(out[0].abs()).all()


@pytest.mark.parametrize("case", sorted(NESTING))
def test_spans_nest_by_layer(cases, case):
    _, spans = _profiled(cases[case])
    want = NESTING[case]
    assert {n for n, *_ in spans} == set(want)
    for name, parent, _, _ in spans:
        if name == "carry":
            assert parent in CARRY_PARENTS
        else:
            assert parent == want[name], (name, parent)
    # a request's spans: one of each; the stream's: one each a block
    counts = {n: sum(1 for s in spans if s[0] == n) for n in want}
    if case == "stream":
        assert counts["filterbank"] == counts["inverse_filterbank"] == BLOCKS
        # the analysis's, from its second call: the inversion joins nothing
        assert counts["carry"] == BLOCKS - 1
    else:
        assert set(counts.values()) == {1}
    # where a dispatch chooses, the chosen epilogue runs after it (on the
    # CPU the out-of-core pair's kernels have no spans)
    for _, _, a, b in (s for s in spans if s[0] == "dispatch"):
        later = [s for s in spans if s[0] == "kernel.ifft_fused" and s[2] >= b]
        assert case == "mid_pair" or later


def test_mid_pair_takes_the_out_of_core_route(cases, monkeypatch):
    g = geometry.SynthesisGeometry(MID_CHAN, MID_L, MID_OV, MID_OS)
    n, lo = g.output_fft_length, g.output_overlap
    assert tsf.epilogue_plan(n, lo) == ("pair", 7 * 128, 512)
    key = (n, 1, 7 * 128, 512, lo, g.fn_width // 2, 7 / 8)
    taken = []
    pair = tsf.fused_big_ifft_oc
    monkeypatch.setattr(tsf, "fused_big_ifft_oc",
                        lambda *a, **k: taken.append(k["shape_key"]) or pair(*a, **k))
    cases["mid_pair"]()
    assert taken == [key]


@pytest.mark.parametrize("case", ["low", "stream"])
def test_outputs_bitwise_with_profiler_on_and_off(cases, case):
    off = cases[case]()
    on, spans = _profiled(cases[case])
    assert spans and len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_carry_bytes_counts_the_cat_outputs(low_filt):
    shapes = []
    before = streaming.carry.bytes
    run_stream(low_filt, _noise((2, 6 * BLOCK), 4), shapes)
    counted = streaming.carry.bytes - before
    # every buffer the analysis carries is joined to the block after it:
    # complex64 bytes of a buffer of n samples and a block of m, per
    # polarisation and channel; the inversion reads its held samples and
    # the block where they lie, and holds a view of the block after
    want = sum(8 * int(np.prod(buf[:-1])) * (buf[-1] + blk[-1])
               for stage, buf, blk in shapes if stage == "filterbank" and buf[-1] > 0)
    assert len(shapes) == 2 * 6 - 2 and counted == want > 0


def test_counters_hold_every_counter(cases):
    before = profiling.counters()
    assert set(before) == {*wrappers(), "analysis_fused_channel_major", "inversion_fused_split",
                           "composed_epilogues", "inversion_transform_points",
                           "inversion_output_samples", "carry_bytes", "corner_turn_bytes"}
    assert all(isinstance(v, int) for v in before.values())
    cases["stream"]()
    after = profiling.counters()
    # the CPU runs the plain versions: no launch, the carries counted
    assert after["carry_bytes"] > before["carry_bytes"]
    assert {k: after[k] - before[k] for k in wrappers()} == dict.fromkeys(wrappers(), 0)
    assert after["analysis_fused_channel_major"] == before["analysis_fused_channel_major"]
    assert after["inversion_fused_split"] == before["inversion_fused_split"]
    # the plain inversion counts its transforms and what they kept too
    points = after["inversion_transform_points"] - before["inversion_transform_points"]
    kept = after["inversion_output_samples"] - before["inversion_output_samples"]
    assert points > kept > 0


@pytest.mark.parametrize("critical", [False, True])
def test_cascade_spans_nest(cascade_configs, critical):
    x = _noise((2, CASCADE_N), 6)
    before = profiling.counters()
    (y, _, z), spans = _profiled(lambda: run_cascade(cascade_configs, x, critical=critical))
    assert z.shape == (2, CASCADE_CHAN, 216 * 192 - 2 * 7776 if not critical
                       else 192 * 192 - 2 * 36 * 192)
    assert {n for n, *_ in spans} == set(CASCADE_NESTING) - CASCADE_INVERSION[not critical]
    for name, parent, _, _ in spans:
        assert parent in CASCADE_NESTING[name], (name, parent)
    counts = {n: sum(1 for s in spans if s[0] == n) for n in CASCADE_NESTING}
    # stage 1 and stage 2 of the forward; its two reshapes and the slabs
    assert counts["filterbank"] == counts["kernel.analysis_fused"] == 2
    assert counts["corner_turn"] == 3
    assert counts["composed_epilogue"] == int(critical)
    assert counts["kernel.inversion_fused"] == int(not critical)
    assert (profiling.counters()["composed_epilogues"]
            == before["composed_epilogues"] + int(critical))
    if critical:
        (dispatch,) = [s for s in spans if s[0] == "dispatch"]
        (composed,) = [s for s in spans if s[0] == "composed_epilogue"]
        assert composed[2] >= dispatch[3]


@pytest.mark.parametrize("kw", [{}, {"critical": True}, {"single": True}])
def test_corner_turn_bytes_counts_the_cascades_copies(cascade_configs, kw):
    """Both stages store channel-major, so stage 1's spectra are one
    stream per coarse channel and stage 2's channels the output's layout
    as they stand: views, as are the inverse's slabs. The critical chomp
    (a slice of each coarse channel's 216 kept channels) leaves the output
    strided, and its reshape copies the output once."""
    x = _noise((2, CASCADE_N), 7)
    before = two_stage.corner_turn.bytes
    y, spectra1, z = run_cascade(cascade_configs, x, **kw)
    counted = two_stage.corner_turn.bytes - before
    assert spectra1 > 0 and y.shape[-1] > 0 and z.shape[-1] > 0
    want = 8 * y.numel() if kw.get("critical") else 0
    assert counted == want
    assert profiling.counters()["corner_turn_bytes"] == two_stage.corner_turn.bytes


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_NESTING))
def test_card_spans_nest_and_match_the_launches(low_filt, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    if case == "stream":
        x = _noise((2, BLOCKS * BLOCK), 5).to(dev)
        run = lambda: run_stream(low_filt, x, device=dev)  # noqa: E731
    else:
        model = (low_round_trip if case == "low" else mid_round_trip)(dev)
        x = _noise((2, 2 ** 23 if case == "low" else 4_587_520), 5).to(dev)
        run = lambda: [model(x)]  # noqa: E731
    run()
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(dev)
    after = profiling.counters()
    spans = _program_spans(prof)
    want = CARD_NESTING[case]
    assert {n for n, *_ in spans} == set(want)
    for name, parent, _, _ in spans:
        assert parent in CARRY_PARENTS if name == "carry" else parent == want[name], (
            name, parent)
    launched = {k: after[k] - before[k] for k in wrappers()}
    assert launched == {k: sum(1 for s in spans if s[0] == f"kernel.{k}") for k in wrappers()}
    assert after["composed_epilogues"] == before["composed_epilogues"]
    # the stream's inversions after the first read their held samples and
    # the block as two inputs
    split = after["inversion_fused_split"] - before["inversion_fused_split"]
    assert split == (BLOCKS - 1 if case == "stream" else 0)


@pytest.mark.cuda
def test_card_cascade_spans_match_the_launches():
    """SKA-Low's PST cascade (sps into lowpsi) on the card over one
    inversion block: the same spans as on the CPU, one ``kernel.<name>``
    span for each launch, both analyses channel-major launches, the
    inversion the fused kernel with no composed epilogue, and no corner
    turn copying."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    configs = load_config("sps"), load_config("lowpsi")
    x = _noise((2, (256 * 192 + 3072 - 1536) * 216 + 6400), 8).to(dev)
    run_cascade(configs, x, device=dev)
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        y, spectra1, z = run_cascade(configs, x, device=dev)
        torch.cuda.synchronize(dev)
    after = profiling.counters()
    spans = _program_spans(prof)
    assert z.shape == (2, 256, 216 * 192 - 2 * 7776)
    assert {n for n, *_ in spans} == set(CASCADE_NESTING) - CASCADE_INVERSION[True]
    for name, parent, _, _ in spans:
        assert parent in CASCADE_NESTING[name], (name, parent)
    launched = {k: after[k] - before[k] for k in wrappers()}
    assert launched == {k: sum(1 for s in spans if s[0] == f"kernel.{k}") for k in wrappers()}
    assert {k: v for k, v in launched.items() if v} == {"analysis_fused": 2,
                                                        "inversion_fused": 1}
    assert after["composed_epilogues"] == before["composed_epilogues"]
    assert after["analysis_fused_channel_major"] - before["analysis_fused_channel_major"] == 2
    assert spectra1 > 0 and after["corner_turn_bytes"] == before["corner_turn_bytes"]
