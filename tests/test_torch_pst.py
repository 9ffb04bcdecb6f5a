"""An SKA-Low PST node's dedispersing inversion on the CPU.

The port's ``TwoStageInverseFilterBank`` with ``dedispersion`` (each coarse
channel's 216 monotonic LowCBF channels inverted in 41,472-point blocks and
coherently dedispersed at PSR J0437-4715's DM, each at its own centre
frequency; each block discards the tukey taper's 48 fine samples and the
widest chirp's reach a side, 64 in all, and keeps 20,736 samples) at the
published widths on 3 coarse channels of the ``lowpst`` plan (150.0 MHz
up, 0.78125 MHz apart: the band's widest chirps), over 3 inversion blocks,
against ``pstbench/references/pst.py`` (plain torch in float64, importing
nothing of the program):

* (a) one call, and the stream in three blocks with the state carried;
* (b) the chirp inside the inversion against inverting without it and then
  dedispersing each coarse channel's whole output, seams and all;
* (c) the plan's chirps against the discard;
* (d) the (rows, N) chirp table: row ``p % rows`` of stream p, and one row
  the same as an (N,) factor;
* (e) the two epilogue kernels that take one (N,) factor refuse a table;
* (f) the discard a DM takes, and the fused kernel taking it;
* (g) a dispersed pulse comes out where the undispersed one does: the
  chirp's bins in the order of the inversion's spectrum.

The plain versions of the kernels run (the tensors lie on the CPU), in
float32 as on the card.
"""

import numpy as np
import pytest
import torch

from pstbench import design, run
from ska_pst_dsp_tpu_torch.models.streaming import FilterBank, InverseFilterBank
from ska_pst_dsp_tpu_torch.models.two_stage import TwoStageInverseFilterBank
from ska_pst_dsp_tpu_torch.ops import dedispersion, synthesis
from ska_pst_dsp_tpu_torch.ops.dedispersion import Dedispersion
from ska_pst_dsp_tpu_torch.ops.kernels import inversion_fused as inv
from ska_pst_dsp_tpu_torch.ops.kernels.ifft_big import fused_big_ifft_oc
from ska_pst_dsp_tpu_torch.ops.kernels.ifft_fused import fused_big_ifft
from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.config import load_config
from ska_pst_dsp_tpu_torch.utils.rational import Rational

#: max |port - reference| / max |reference|. The port computes in float32
#: through the inversion's 256- and 41,472-point transforms and reads the
#: chirp stored as complex64 (phases up to ~3e3 rad, each taken in float64);
#: it reads 1.8e-7 to 2.1e-7 here (three seeds). Ten times the largest
#: reading and more; the reference in bfloat16 reads 3.5e-3 to 4.5e-3, over
#: a thousand times this.
TOL = 3e-6
#: (b): max |inside - after| / max |after| away from the seams, where the
#: two differ by the chirp's response past its reach: 1.4e-3 to 1.6e-3.
TOL_AFTER = 1e-2
DM, FIRST, BW = 2.64476, 150.0, 0.78125
#: the tukey taper's edge (fine samples, lowpsi's input_overlap), the
#: overlap the node discards a side (the taper and the widest chirp's reach
#: of 1,992 output samples, 13 fine samples, rounded up to a multiple of
#: nu = 4), the hop, an inversion block's kept output samples and its
#: output discard a side
TAPER, OVERLAP = 48, 64
KEEP, OUT_KEEP, DISCARD = 256 - 2 * OVERLAP, 216 * 192 - 2 * 64 * 162, 64 * 162
COARSE, N = 3, 216 * 192
OS = Rational(4, 3)


def _noise(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(shape, generator=g), torch.randn(shape, generator=g))


def rel_err(got, want):
    assert got.shape == want.shape
    return float((got.to(want.dtype) - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def lowpsi():
    return load_config("lowpsi")


@pytest.fixture(scope="module")
def cfg():
    return run.load_json(run.HERE / "configs" / "lowpst.json")


@pytest.fixture(scope="module")
def references(cfg):
    """precision -> the benchmark's reference of the lowpst configuration."""
    mod = run.load_module(run.HERE / "references" / "pst.py")
    filt = design.prototype_filter(cfg)
    return {p: mod.Pst(cfg, filt, "cpu", p) for p in ("fp64", "bf16")}


@pytest.fixture(scope="module")
def fine():
    """Both polarisations of 3 coarse channels' 216 fine channels,
    channel-major, three inversion blocks long."""
    return _noise((2, COARSE * 216, 3 * KEEP + 2 * OVERLAP), 29)


def node(lowpsi, dedisp=Dedispersion(DM, FIRST, BW)):
    return TwoStageInverseFilterBank(lowpsi, nch2=216, device="cpu", dedispersion=dedisp)


@pytest.mark.parametrize("calls", [1, 3])
def test_the_node_against_the_reference(lowpsi, references, fine, calls):
    """(a) In one call, and as three calls with the state carried (the
    first sets the chunk to one block)."""
    inv_ = node(lowpsi)
    state = inv_.init_state()
    cuts = [0, fine.shape[-1]] if calls == 1 else [0, KEEP + 2 * OVERLAP, 2 * KEEP + 2 * OVERLAP,
                                                   fine.shape[-1]]
    outs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        state, z = inv_.execute(state, fine[:, :, a:b])
        outs.append(z)
    got = torch.cat(outs, dim=-1)
    assert got.shape == (2, COARSE, 3 * OUT_KEEP)
    want = references["fp64"].inversion(fine)
    assert rel_err(got, want) < TOL
    assert rel_err(references["bf16"].inversion(fine), want) > 100 * TOL


def test_the_port_and_the_reference_take_the_same_filter(lowpsi, cfg):
    assert np.array_equal(lowpsi.load_fir_filter_coeff(), design.prototype_filter(cfg))


def _analysed(x, t2):
    """The LowCBF stage's fine channels of coarse streams x, (1, coarse *
    216, t2) channel-major."""
    fb = FilterBank(load_config("lowpsi"), device="cpu", channel_major=True)
    _, y = fb.execute(fb.init_state(), x)
    return y[..., :t2].reshape(1, -1, t2)


def _after(z, f0):
    """Coarse channel z dedispersed at its centre f0 as one whole-stream
    convolution, on the monotonic inversion's spectrum order (its centre at
    bin n/2)."""
    h = np.fft.fftshift(dedispersion.chirp_filter(z.shape[-1], DM, f0, BW))
    return torch.fft.ifft(torch.fft.fft(z.to(torch.complex128)) * torch.as_tensor(h))


def test_inside_the_inversion_is_dedispersing_after_it(lowpsi):
    """(b) Five blocks of an analysed stream (the LowCBF stage on three
    coarse streams of noise): the chirp inside the inversion against the
    inversion without it and then each coarse channel's whole output
    dedispersed at its centre, on the three middle blocks (the whole
    output's dedispersion wraps round at its ends). Away from the seams the
    two agree to the chirp's response past its reach. Within its reach of a
    seam the chirp inside reads the block's own reconstruction of the
    untapered samples it discards, and after it the next block's: the two
    differ by the LowCBF inversion's own block-to-block error, which is what
    two inversions of the same stream at two hops differ by. The seams read
    0.66 to 0.83 of that over three seeds; with a discard of the taper's
    overlap alone (the chirp reading tapered samples) 1.19 to 1.64."""
    blocks = 5
    t2 = blocks * KEEP + 2 * OVERLAP
    y = _analysed(_noise((COARSE, t2 * 192 + 3072 - 1536), 31), t2)
    inside = node(lowpsi)
    _, z_in = inside.execute(inside.init_state(), y)
    assert z_in.shape == (1, COARSE, blocks * OUT_KEEP)
    # without the chirp at the node's hop, and at the taper's (lowpsi's own)
    plain = InverseFilterBank(lowpsi, monotonic=True, device="cpu", overlap=OVERLAP)
    _, z_plain = plain.execute(plain.init_state(), y.reshape(COARSE, 216, t2))
    other = InverseFilterBank(lowpsi, monotonic=True, device="cpu")
    _, z_other = other.execute(other.init_state(), y.reshape(COARSE, 216, t2))
    shift = (OVERLAP - TAPER) * 162  # the other's output starts this much earlier
    mid = slice(OUT_KEEP, (blocks - 1) * OUT_KEEP)
    for c in range(COARSE):
        after = _after(z_plain[c, 0], FIRST + BW * c)
        diff = (z_in[0, c] - after).abs() / after.abs().max()
        reach = int(np.ceil(dedispersion.reach_samples(DM, FIRST + BW * c, BW)))
        interior = max(float(diff[k * OUT_KEEP + reach:(k + 1) * OUT_KEEP - reach].max())
                       for k in range(1, blocks - 1))
        hops = z_other[c, 0, shift + mid.start:shift + mid.stop] - z_plain[c, 0, mid]
        own = float(hops.abs().max() / z_plain[c, 0].abs().max())
        assert interior < TOL_AFTER and float(diff[mid].max()) < own


def test_a_dispersed_pulse_comes_out_where_the_undispersed_one_does(lowpsi):
    """(g) The chirp's bins in the inversion's spectrum order: a band-limited
    pulse dispersed at 150 MHz in the coarse stream comes out of the node at
    the sample the undispersed pulse comes out of the node without
    dedispersion; the chirp on DC-first bins would take the band's centre
    for its edge and put it ~1,990 samples late."""
    t2 = 3 * KEEP + 2 * OVERLAP
    n = t2 * 192 + 3072 - 1536
    f = np.fft.fftfreq(n) * BW * 32 / 27  # MHz from the coarse channel's centre
    pulse = np.fft.fft(np.eye(1, n, n // 2)[0]) * (np.abs(f) < 0.45 * BW)
    phase = 2 * np.pi * dedispersion.KDM * 1e6 * DM * f**2 / (FIRST**2 * (FIRST + f))
    peaks = []
    for spectrum, dedisp in ((pulse, None),
                             (pulse * np.exp(-1j * phase), Dedispersion(DM, FIRST, BW))):
        y = _analysed(torch.as_tensor(np.fft.ifft(spectrum)[None]).to(torch.complex64), t2)
        inv_ = node(lowpsi, dedisp)
        if dedisp is None:  # at the node's hop
            inv_.init_state()
            inv_._inv = InverseFilterBank(lowpsi, monotonic=True, device="cpu", overlap=OVERLAP)
        _, z = inv_.execute(inv_.init_state(), y)
        peaks.append(int(z[0, 0].abs().argmax()))
    assert abs(peaks[1] - peaks[0]) <= 2


def test_the_plan_fits_the_discard_and_ten_times_the_dm_does_not(lowpsi, cfg):
    """(c) Every coarse channel of lowpst's plan: the taper's 7,776 output
    samples and the chirp's reach within the node's discard of 10,368 a side
    (the smear 3,969 samples at 150.0 MHz, 315 at 349.2); ten times the DM
    is refused at init_state."""
    plan = Dedispersion(cfg["dm"], cfg["first_coarse_centre_mhz"], cfg["coarse_bw_mhz"])
    centres = plan.centres(cfg["coarse_channels"])
    assert centres[0] == 150.0 and centres[-1] == 349.21875
    reach = [dedispersion.reach_samples(plan.dm, f, plan.coarse_bw_mhz) for f in centres]
    assert max(reach) == plan.reach() and TAPER * 162 + plan.reach() < DISCARD
    for f, smear in ((centres[0], 3969), (centres[-1], 315)):
        assert round(dedispersion.dispersion_delay(plan.dm, f - BW / 2, f + BW / 2) * BW
                     * 1e6) == smear
    inv_ = node(lowpsi, plan)
    inv_.init_state()
    assert (inv_._inv.overlap, inv_._geom.output_overlap) == (OVERLAP, DISCARD)
    with pytest.raises(ValueError, match="input overlap of 172 .* needs a longer inversion"):
        node(lowpsi, Dedispersion(10 * DM, FIRST, BW)).init_state()


def test_the_chirp_table_is_one_chirp_a_channel():
    table = dedispersion.chirp_table(N, DM, [FIRST, FIRST + BW], BW)
    assert table.shape == (2, N) and table.dtype == np.complex64
    for r, f0 in enumerate((FIRST, FIRST + BW)):
        assert np.array_equal(table[r], dedispersion.chirp_filter(N, DM, f0, BW))
    # the band's largest phase, at 150 MHz: float32 would be off by ~2e-4 rad
    assert 3e3 < np.abs(dedispersion.chirp_phase(N, DM, FIRST, BW)).max() < 3.3e3


def _slab_args(elem):
    """inversion_fused's arguments after the stream at a slab's geometry,
    two blocks, with ``elem``."""
    g = geometry.SynthesisGeometry(216, 256, OVERLAP, OS)
    c = synthesis.synthesis_constants(216, 256, OS, OVERLAP, temporal_taper="tukey",
                                      monotonic=True, taper_overlap=TAPER)
    consts = [torch.as_tensor(c[k]) for k in ("t_taper", "dr", "perm")]
    return (*consts, elem, g.input_keep, (128 + g.discard) % 256, 2, g.output_overlap,
            g.fn_width // 2, 0.75)


def test_row_p_mod_rows_is_the_row_of_stream_p():
    """(d) Six streams over a table of three rows: stream p as if alone
    with row p % 3; one row as (1, N) the same as (N,)."""
    x = _noise((6, 216, 2 * KEEP + 2 * OVERLAP), 37).transpose(1, 2)
    table = torch.as_tensor(_noise((3, N), 38))
    got = inv.inversion_fused(x, *_slab_args(table))
    for p in range(6):
        alone = inv.inversion_fused(x[p:p + 1], *_slab_args(table[p % 3]))
        assert torch.equal(got[p:p + 1], alone)
    assert torch.equal(inv.inversion_fused(x, *_slab_args(table[:1])),
                       inv.inversion_fused(x, *_slab_args(table[0])))
    # synthesis_constants rolls each row as it rolls an (N,) filter
    rows = synthesis.synthesis_constants(216, 256, OS, OVERLAP, monotonic=True,
                                         spectral_filter=table.numpy())["elem"]
    one = synthesis.synthesis_constants(216, 256, OS, OVERLAP, monotonic=True,
                                        spectral_filter=table[1].numpy())["elem"]
    assert rows.shape == (3, N) and np.array_equal(rows[1], one)
    # the single-stage stream takes the same table as its spectral filter
    chirps = Dedispersion(DM, FIRST, BW).table(N, 2, centred=True)
    single = InverseFilterBank(load_config("lowpsi"), monotonic=True, device="cpu",
                               overlap=OVERLAP).set_spectral_filter(chirps)
    fine = _noise((4, 216, 2 * KEEP + 2 * OVERLAP), 40)
    _, got = single.execute(single.init_state(), fine)
    two = node(load_config("lowpsi"), Dedispersion(DM, FIRST, BW))
    _, want = two.execute(two.init_state(), fine.reshape(2, 2 * 216, -1))
    assert torch.equal(got.reshape(2, 2, -1), want)
    # no dedispersion: no elem, as lowpsi.cascade runs
    plain = TwoStageInverseFilterBank(load_config("lowpsi"), nch2=216, device="cpu")
    plain.execute(plain.init_state(), _noise((1, 216, 256), 39))
    assert plain._inv.elem is None


@pytest.mark.parametrize("route", ["cluster", "pair"])
def test_the_single_factor_epilogues_refuse_a_table(route):
    """(e) No route applies row 0 of a table to every stream."""
    x = _noise((2, 1, 49152), 41)
    table = torch.as_tensor(_noise((2, 49152), 42))
    with pytest.raises(ValueError, match="one \\(N,\\) elem"):
        if route == "cluster":
            fused_big_ifft(x, table, shape_key=(49152, 128, 384, 9216, 96, 0.75))
        else:
            fused_big_ifft_oc(x, table, shape_key=(49152, 1, 128, 384, 9216, 96, 0.75))


@pytest.mark.parametrize("dm,overlap", [(0.0, 48), (DM, 64), (4 * DM, 100)])
def test_the_discard_is_the_taper_and_the_reach(lowpsi, dm, overlap):
    """(f) The node's input overlap: the taper's 48 (lowpsi's) and the
    lowest channel's reach in whole fine samples of 162 output samples,
    rounded up to a multiple of nu = 4; the tukey taper stays at 48 (its
    edges the same as lowpsi's own inversion's); and the fused kernel on
    the card takes the wider discard."""
    inv_ = node(lowpsi, Dedispersion(dm, FIRST, BW))
    inv_.init_state()
    reach = dedispersion.reach_samples(dm, FIRST, BW)
    assert inv_._inv.overlap == overlap == -(-(TAPER + int(np.ceil(reach / 162))) // 4) * 4
    inv_.execute(inv_.init_state(), _noise((1, 216, 256), 43))
    own = synthesis.synthesis_constants(216, 256, OS, TAPER, temporal_taper="tukey")
    assert np.array_equal(inv_._inv.t_taper.numpy(), own["t_taper"])
    g = inv_._geom
    assert g.output_overlap == overlap * 162
    assert inv.takes(256, 216, g.output_fft_length, g.output_overlap)
