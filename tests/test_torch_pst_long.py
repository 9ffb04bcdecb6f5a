"""An SKA-Low PST node at a DM that needs a longer frame, on the CPU.

PSR J1909-3744 (DM 10.3919): the chirp of the 150.0 MHz coarse channel
reaches 7,829 output samples, 49 fine samples of 162, so beside the tukey
taper's 48 each frame discards 100 fine samples a side (rounded up to a
multiple of nu = 4). A 256-sample frame would keep 56 of them; the
``lowpst1909`` configuration inverts each coarse channel's 216 monotonic
LowCBF channels in 512-sample frames, 82,944 = 216 * 384-point blocks that
keep 312 fine samples, 50,544 output samples, a block
(``inversion_fused``'s third plan). Here, on 3 coarse channels of that
plan (150.0 MHz up, 0.78125 MHz apart: the band's widest chirps):

* (a) the node against ``pstbench/references/pst.py`` (plain torch in
  float64, importing nothing of the program), in one call and as three
  calls with the state carried;
* (b) the discard and the hop at J1909-3744's DM, and a DM past the
  256-sample frame's refused with the frame lengths that would take it;
* (c) the fused kernel's predicate and host tables at L 512;
* (d) csrc/inversion_fused.cu's index maps at L 512 (16 * 32 frontend, two
  bins a thread in its second pass) in numpy against the plain version;
* (e) the counters that say what a frame length costs.

Tests marked ``cuda`` hold the L 512 plan to its plain version on the card:
at the node's request, two inputs bit for bit as their join, and row
``p % rows`` of a chirp table. The rest run the plain versions (the
tensors lie on the CPU), in float32 as on the card.
"""

import numpy as np
import pytest
import torch

from pstbench import design, run, system
from ska_pst_dsp_tpu_torch.models.two_stage import TwoStageInverseFilterBank
from ska_pst_dsp_tpu_torch.ops import dedispersion
from ska_pst_dsp_tpu_torch.ops import synthesis as tsynth
from ska_pst_dsp_tpu_torch.ops.dedispersion import Dedispersion
from ska_pst_dsp_tpu_torch.ops.kernels import inversion_fused as inv
from ska_pst_dsp_tpu_torch.ops.kernels import synthesis_fused as tsf
from ska_pst_dsp_tpu_torch.ops.kernels import twiddle_table
from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.rational import Rational
from test_torch_kernels import (
    SYNTHESIS_TOL, _dft_matrix, _low_inversion_args, _rel_err, _strided_input,
    emu_frame_load, emu_inversion_epilogue,
)
# TOL, max |port - reference| / max |reference|, is test_torch_pst.py's and
# holds for the same reason at L 512: the port computes in float32 through
# the inversion's 512- and 82,944-point transforms and reads the chirp
# stored as complex64 (phases up to ~1.2e4 rad, each taken in float64). It
# reads 2.24e-7 to 2.36e-7 here (three seeds): ten times the largest and
# more; the reference in bfloat16 reads 3.86e-3 to 4.11e-3, over a thousand
# times this.
from test_torch_pst import TOL, _noise, rel_err

DM, FIRST, BW = 10.3919, 150.0, 0.78125
#: the discard a side (fine samples), the hop, a block's points, its kept
#: output samples and its output discard a side
OVERLAP, L512 = 100, 512
KEEP, N = L512 - 2 * OVERLAP, 216 * 384
OUT_KEEP, DISCARD = N - 2 * OVERLAP * 162, OVERLAP * 162
COARSE = 3
OS = Rational(4, 3)


@pytest.fixture(scope="module")
def cfg():
    """The lowpst1909 configuration on COARSE of its coarse channels."""
    c = run.load_json(run.HERE / "configs" / "lowpst1909.json")
    return {**c, "coarse_channels": COARSE}


@pytest.fixture(scope="module")
def filt(cfg):
    return design.prototype_filter(cfg)


@pytest.fixture(scope="module")
def stage(cfg, filt):
    """The configuration's LowCBF stage as the program's streaming stages
    read it (as the benchmark's kind builds it)."""
    s = system.PortConfig(cfg, filt)
    s.kept_channels = cfg["kept_channels"]
    return s


@pytest.fixture(scope="module")
def references(cfg, filt):
    """precision -> the benchmark's reference of the configuration."""
    mod = run.load_module(run.HERE / "references" / "pst.py")
    return {p: mod.Pst(cfg, filt, "cpu", p) for p in ("fp64", "bf16")}


def node(stage, dm=DM, device="cpu"):
    return TwoStageInverseFilterBank(stage, nch2=216, device=device,
                                     dedispersion=Dedispersion(dm, FIRST, BW))


@pytest.mark.parametrize("calls", [1, 3])
def test_the_node_against_the_reference(stage, references, calls):
    """(a) Three inversion blocks of both polarisations of 3 coarse
    channels, channel-major, in one call and as three calls with the state
    carried (the first sets the chunk to one block)."""
    fine = _noise((2, COARSE * 216, 3 * KEEP + 2 * OVERLAP), 1909)
    inv_ = node(stage)
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


def test_the_discard_and_the_hop_at_j1909s_dm(stage, cfg):
    """(b) The taper's 48 and the reach's 49 fine samples, rounded up to a
    multiple of nu = 4: 100 a side, a hop of 312, the reference's own
    discard; the output discard 16,200 = 75 rows of 216."""
    inv_ = node(stage)
    inv_.init_state()
    reach = dedispersion.reach_samples(DM, FIRST, BW)
    assert 7828 < reach < 7829 and inv_.dedispersion_overlap() == OVERLAP
    assert inv_._inv.overlap == OVERLAP and inv_._inv.n_fft - 2 * OVERLAP == KEEP == 312
    g = inv_._geom
    assert (g.output_fft_length, g.output_overlap, g.output_keep) == (N, DISCARD, OUT_KEEP)
    assert DISCARD == 75 * 216
    ref = run.load_module(run.HERE / "references" / "pst.py")
    assert ref.overlap(cfg) == OVERLAP


def test_a_dm_past_the_frame_names_the_frames_that_take_it():
    """(b) PSR J0613-0200 (DM 38.7746) at the upstream 256-sample frame:
    its discard of 232 a side leaves nothing, and the refusal names the
    fused inversion's frame lengths at 216 channels and what each keeps,
    L 512 keeping 48."""
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    with pytest.raises(ValueError, match=r"input overlap of 232 .* needs a longer inversion "
                                         r"\(.*L 256, which would keep 0 of each frame; "
                                         r"L 512, which would keep 48 of each frame\)"):
        node(load_config("lowpsi"), 38.7746).init_state()
    assert inv.frame_lengths(216) == {256: 216 * 192, 512: N}
    assert inv.frame_lengths(256) == {256: 256 * 192} and inv.frame_lengths(100) == {}


@pytest.mark.parametrize("lo,taken", [
    (DISCARD, True),                  # J1909-3744's discard: 75 rows
    (48 * 162, True),                 # the taper's alone: 7,776 = 36 rows
    (DISCARD + 216, True),            # any whole number of rows
    (DISCARD + 108, False),           # off whole rows
    (DISCARD - 4, False),
    (N // 2, False),                  # a discard that keeps nothing
])
def test_the_kernel_takes_the_node_at_l512(lo, taken):
    """(c) The predicate at L 512: whole rows of n2 = 216 that keep some."""
    assert inv.takes(L512, 216, N, lo) == taken
    assert inv.GEOMETRIES[(L512, 216, N)] == (216, 384)
    assert not inv.takes(L512, 256, 256 * 384, 18_432)  # no L 512 plan at 256 channels
    assert tsf.epilogue_plan(N, DISCARD)[0] == "composed"  # no epilogue kernel either


def test_the_kernel_tables_at_l512():
    """(c) kernel_tables(82944, 216, 384) against numpy's float64
    exponentials: the radix-6 column passes of span 36 and 6, w_384^m, the
    N-level twiddle split at S = 36 and the 128-point row table."""
    tab = inv.kernel_tables(N, 216, 384)
    assert set(tab) == {"tw_col", "tw_n1", "tw_a", "tw_b", "tw_row"}
    assert all(t.dtype == np.complex64 for t in tab.values())
    cols = []
    for h in (36, 6):
        jd = np.arange(1, 6)[:, None] * np.arange(h)[None, :]
        cols.append(np.exp(2j * np.pi * jd / (6 * h)).ravel())
    want = {
        "tw_col": np.concatenate(cols),
        "tw_n1": np.exp(2j * np.pi * np.arange(384) / 384),
        "tw_a": np.exp(2j * np.pi * 36 * np.arange(6)[:, None] * np.arange(384)[None, :] / N),
        "tw_b": np.exp(2j * np.pi * np.arange(36)[:, None] * np.arange(384)[None, :] / N),
    }
    for k, w in want.items():
        assert tab[k].shape == w.shape
        assert np.abs(tab[k] - w).max() < 1e-7, k
    # w_N^(m1*k2) = tw_a[k2 // 36] * tw_b[k2 % 36] for every k2 < 216
    k2 = np.arange(216)
    prod = tab["tw_a"][k2 // 36] * tab["tw_b"][k2 % 36]
    assert np.abs(prod - np.exp(2j * np.pi * k2[:, None] * np.arange(384)[None, :] / N)).max() < 3e-7
    assert np.array_equal(tab["tw_row"], inv.kernel_tables(41472, 216, 192)["tw_row"])


def emu_inversion_fused_16xm(x, taper, dr, perm, elem, keep, kpos, n_blocks, lo, roll, gain,
                             held=None):
    """inversion_fused_kernel on a (n_pol, n_dat, n_chan) stream at any of
    inv.GEOMETRIES, L = 16 * M: block r of the cluster is the frontend of
    channels [C*r, C*r + C) in halves of 16 and C - 16; each channel's
    first pass (the thread of (c, j), t = j + 16*m, m < M: taper, the
    M-point DFT over m, times w_L^(j*d) from the exact table) stores into
    a row of L + 1 at M*j + (d + j) % M (lanes on time); its second pass
    (the thread of (c, d0), d = d0 + 16*q for q < M/16) reads them back,
    runs the 16-point DFT over j: bin d + M*e; each kept bin
    j' = (k - kpos) mod L < FN_width, times dr[j'] * gain/N, goes to
    k' = (FNW*c + j' - roll) mod N of block (k' % n1) // (n1/8)'s columns,
    each slot exactly once; then emu_inversion_epilogue. Returns the output
    and the count of stores per sample."""
    n_pol, _, n_chan = x[1]
    n_l, fnw, cl = taper.size, dr.size, 8
    m_pts = n_l // 16
    n = n_chan * fnw
    n2, n1 = inv.GEOMETRIES[(n_l, n_chan, n)]
    cpc, per = n1 // cl, n_chan // cl
    halves = [r * per + h * 16 + np.arange(min(16, per - 16 * h))
              for r in range(cl) for h in range(2)]
    assert np.array_equal(np.sort(np.concatenate(halves)), np.arange(n_chan))
    # the row positions of the first pass: each slot of a row once, and a
    # half-warp's 16 j at one d on 16 banks (a float2 slot p on bank p % 16)
    j, d = np.arange(16)[:, None], np.arange(m_pts)[None, :]
    pos = m_pts * j + (d + j) % m_pts
    assert np.array_equal(np.sort(pos.ravel()), np.arange(n_l))
    assert all(len(set(pos[:, dd] % 16)) == 16 for dd in range(m_pts))
    frames, _ = emu_frame_load(x, held, perm, keep, n_blocks, n_l)
    v = (frames.transpose(0, 1, 3, 2) * taper).astype(np.complex64)  # [p, b, c, t]
    v = v.reshape(n_pol, n_blocks, n_chan, m_pts, 16)  # [.., m, j]
    a = np.einsum("...mj,md->...jd", v, _dft_matrix(m_pts, -1))
    a = a * twiddle_table(n_l, -1)[j * d]
    row = np.empty(a.shape[:-2] + (n_l,), np.complex64)
    row[..., pos] = a
    y = np.empty_like(row)
    for q in range(m_pts // 16):
        dd = np.arange(16) + 16 * q
        w = row[..., m_pts * np.arange(16)[:, None] + (dd[None, :] + np.arange(16)[:, None])
                % m_pts]  # [.., j, d0]
        y[..., dd[None, :] + m_pts * np.arange(16)[:, None]] = np.einsum(
            "...jd,je->...ed", w, _dft_matrix(16, -1))  # bin d + M*e
    jk = (np.arange(n_l) - kpos) % n_l
    kept = jk < fnw
    scale = np.float32(gain / n)
    cols = np.zeros((n_pol, n_blocks, cl, n // n1, cpc), np.complex64)
    stores = np.zeros(cols.shape, np.int64)
    c = np.arange(n_chan)[:, None]
    k = (fnw * c + jk[kept][None, :] - roll) % n
    m2, m1 = k // n1, k % n1
    cols[:, :, m1 // cpc, m2, m1 % cpc] = y[..., kept] * (dr[jk[kept]] * scale)
    np.add.at(stores, (slice(None), slice(None), m1 // cpc, m2, m1 % cpc), 1)
    assert (stores == 1).all()
    flat = cols.transpose(0, 1, 3, 2, 4).reshape(n_pol, n_blocks, n)
    e = None if elem is None else np.roll(elem, -roll)
    return emu_inversion_epilogue(flat, e, n, lo, n_blocks)


@pytest.mark.parametrize("n_l,ov,seam", [(256, 64, 0), (512, OVERLAP, 0), (512, OVERLAP, 400)])
def test_the_kernel_emulation_at_both_frame_lengths(n_l, ov, seam):
    """(d) The index maps of the 16 * (L/16) frontend, with lanes on time
    (the slab's), at the PST node's discards (J0437-4715's at L 256,
    J1909-3744's at L 512), with a seam between held samples and the new
    block inside the second frame: every kept sample stored once, and the
    plain version's output."""
    g, consts, keep, kpos, lo, roll, gain, elem = _low_inversion_args(
        216, n_l=n_l, ov=ov, elem_seed=1910, monotonic=True, taper_overlap=48)
    nb = 2
    n_all = 2 * ov + nb * keep
    held, held_t = _strided_input(1, seam, 216, "channel_major", 1911) if seam else (None, None)
    x, x_tc = _strided_input(1, n_all - seam, 216, "channel_major", 1912)
    got, stores = emu_inversion_fused_16xm(x, *(t.numpy() for t in consts), elem, keep, kpos,
                                           nb, lo, roll, gain, held=held)
    assert (stores == 1).all()
    ref = inv.inversion_fused(x_tc, *consts, torch.as_tensor(elem), keep, kpos, nb, lo, roll,
                              gain, held=held_t).numpy()
    assert got.shape == ref.shape == (1, nb, g.output_keep)
    assert _rel_err(got, ref) < SYNTHESIS_TOL


def test_the_counters_read_what_the_frame_costs(stage):
    """(e) fused_inversion counts each transform's points and the output
    samples it kept: 82,944 for 50,544 at L 512, 1.641; the same node at
    L 256 would count 41,472 for 9,072, 4.571."""
    counts = tsf.fused_inversion
    before = (counts.transform_points, counts.output_samples)
    inv_ = node(stage)
    fine = _noise((1, 216, 4 * KEEP + 2 * OVERLAP), 1913)
    _, z = inv_.execute(inv_.init_state(), fine)
    points = counts.transform_points - before[0]
    kept = counts.output_samples - before[1]
    assert (points, kept) == (4 * N, 4 * OUT_KEEP) and z.shape[-1] == kept
    assert points / kept == pytest.approx(1.641, abs=1e-3)
    assert (216 * 192) / (216 * 192 - 2 * OVERLAP * 162) == pytest.approx(4.571, abs=1e-3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _node_args(device):
    """inversion_fused's constants and geometry at the L 512 node's slab,
    the real deripple of the configuration's filter."""
    cfg = run.load_json(run.HERE / "configs" / "lowpst1909.json")
    g = geometry.SynthesisGeometry(216, L512, OVERLAP, OS)
    c = tsynth.synthesis_constants(216, L512, OS, OVERLAP, temporal_taper="tukey",
                                   monotonic=True, taper_overlap=48,
                                   deripple_coeff=design.prototype_filter(cfg))
    consts = [torch.as_tensor(c[k], device=device) for k in ("t_taper", "dr", "perm")]
    return g, consts, g.input_keep, (L512 // 2 + g.discard) % L512, g.output_overlap, \
        g.fn_width // 2, 0.75


def _table(device, rows=256):
    return torch.as_tensor(Dedispersion(DM, FIRST, BW).table(N, rows, centred=True),
                           device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [4, 8])
def test_card_l512_plan_against_plain(cuda, nb):
    """The node's request on the card: 512 slabs (2 pol x 256 coarse
    channels) of 216 channel-major channels, stream p reading row p % 256
    of the (256, 82,944) chirp table, against the frontend then the
    epilogue in plain torch; the plan's clusters resident."""
    g, consts, keep, kpos, lo, roll, gain = _node_args(cuda)
    n_dat = 2 * OVERLAP + nb * keep
    gen = torch.Generator(device=cuda).manual_seed(1920 + nb)
    x = torch.randn((512, 216, n_dat + 100), dtype=torch.complex64, device=cuda,
                    generator=gen)[:, :, :n_dat].transpose(1, 2)
    table = _table(cuda)
    before = inv.inversion_fused.launches
    got = inv.inversion_fused(x, *consts, table, keep, kpos, nb, lo, roll, gain)
    assert inv.inversion_fused.launches == before + 1
    fn = tsynth.frontend(x, *consts, L512, keep, kpos, nb)
    ref = tsynth.epilogue(fn.reshape(512, nb, N), table, lo, roll, gain, nb)
    assert got.shape == ref.shape == (512, nb, OUT_KEEP)
    assert ((got - ref).abs().max() / ref.abs().max()).item() < SYNTHESIS_TOL
    assert inv.active_clusters(216, L512) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("h", [0, 150, 2 * KEEP, 3 * KEEP + 37])
def test_card_l512_two_inputs_are_their_join(cuda, h):
    """Held samples and a new block read across the seam: bit for bit the
    launch on torch.cat(held, x), each such launch counted once."""
    g, consts, keep, kpos, lo, roll, gain = _node_args(cuda)
    nb = 5
    n_all = 2 * OVERLAP + nb * keep
    gen = torch.Generator(device=cuda).manual_seed(1930)
    buf = torch.randn((16, 216, n_all + 7), dtype=torch.complex64, device=cuda, generator=gen)
    held = buf[:, :, 7:7 + h].transpose(1, 2) if h else None
    x = torch.randn((16, 216, n_all - h), dtype=torch.complex64, device=cuda,
                    generator=gen).transpose(1, 2)
    table = _table(cuda, 8)
    joined = x if held is None else torch.cat([held, x], dim=1)
    want = inv.inversion_fused(joined, *consts, table, keep, kpos, nb, lo, roll, gain)
    before = inv.inversion_fused.split_launches
    got = inv.inversion_fused(x, *consts, table, keep, kpos, nb, lo, roll, gain, held=held)
    assert inv.inversion_fused.split_launches == before + (held is not None)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_card_l512_row_p_mod_rows_is_the_row_of_stream_p(cuda):
    """Six streams over a table of three rows: stream p as if alone with
    row p % 3; one row as (1, N) the same bits as (N,)."""
    g, consts, keep, kpos, lo, roll, gain = _node_args(cuda)
    nb = 2
    x = torch.as_tensor(_noise((6, 216, 2 * OVERLAP + nb * keep), 1940),
                        device=cuda).transpose(1, 2)
    table = torch.as_tensor(_noise((3, N), 1941), device=cuda)
    got = inv.inversion_fused(x, *consts, table, keep, kpos, nb, lo, roll, gain)
    for p in range(6):
        alone = inv.inversion_fused(x[p:p + 1], *consts, table[p % 3], keep, kpos, nb, lo, roll,
                                    gain)
        assert torch.equal(got[p:p + 1], alone)
    assert torch.equal(inv.inversion_fused(x, *consts, table[:1], keep, kpos, nb, lo, roll, gain),
                       inv.inversion_fused(x, *consts, table[0], keep, kpos, nb, lo, roll, gain))
