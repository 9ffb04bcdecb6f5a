"""The port's kernel modules (ska_pst_dsp_tpu_torch.ops.kernels).

On the CPU each wrapper runs its plain PyTorch version; that is held to the
JAX package's Pallas function in interpret mode, as tests/test_pallas.py
runs it, at that file's tolerances (8e-6 * scale analysis, 1.2e-5 * scale
synthesis and epilogue, 1e-5 * scale padded analysis, 1e-4 * scale
out-of-core IFFT).

The CUDA kernels cannot run here, so their decomposition is emulated in
numpy: the same host tables (twiddle_table, pass_twiddles, ramp_table), the
same index maps (strided loads, the register passes' rev8
outputs, the shared-memory swizzles, the four-step t = k2 + n2*k1) and the
same split of each DFT (radix r, then radix-8 register passes in
fft_reg.cuh) and the same staging (work units, slots, bulk copies and the
bytes each barrier expects) as csrc/*.cu, checked against np.fft and the
plain versions. An index bug then shows here before the card. Tests marked ``cuda`` compare each kernel with its plain version
on a card and skip without one; this module imports JAX only inside the
tests that need it, so on a machine with a card and no JAX they run with
``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``.
"""

import math

import numpy as np
import pytest
import torch

from ska_pst_dsp_tpu.design import fir
from ska_pst_dsp_tpu.utils import geometry
from ska_pst_dsp_tpu.utils.rational import Rational
from ska_pst_dsp_tpu_torch.ops import dedispersion
from ska_pst_dsp_tpu_torch.ops import synthesis as tsynth
from ska_pst_dsp_tpu_torch.ops import lowcbf
from ska_pst_dsp_tpu_torch.ops.analysis import (
    _prep_filter, analysis_core, chan_dft_core, padded_chan_const, padded_fold,
    ramp_table,
)
from ska_pst_dsp_tpu_torch.ops.kernels import (
    SMEM_LIMIT, pass_twiddles, radix, reg_plan, twiddle_table, wrappers,
)
from ska_pst_dsp_tpu_torch.ops.kernels import chan_dft_fused as cdf
from ska_pst_dsp_tpu_torch.ops.kernels import synthesis_fused as tsf
from ska_pst_dsp_tpu_torch.ops.kernels import analysis_padded_fused as apf
from ska_pst_dsp_tpu_torch.ops.kernels import ifft_big as big
from ska_pst_dsp_tpu_torch.ops.kernels import analysis_fused as af
from ska_pst_dsp_tpu_torch.ops.kernels import ifft_fused as itf
from ska_pst_dsp_tpu_torch.ops.kernels import inversion_fused as inv
from ska_pst_dsp_tpu_torch.ops.kernels.analysis_fused import (
    analysis_fused, polyphase_analysis_fused,
)
from ska_pst_dsp_tpu_torch.ops.kernels.chan_dft_fused import chan_dft_ramp
from ska_pst_dsp_tpu_torch.ops.kernels.ifft_big import (
    fused_big_ifft_oc, ifft_big_inner, ifft_big_outer, plan_big_ifft,
)
from ska_pst_dsp_tpu_torch.ops.kernels.ifft_fused import fused_big_ifft, plan_ifft
from ska_pst_dsp_tpu_torch.ops.kernels.synthesis_fused import (
    polyphase_synthesis_fused, synthesis_fused,
)

OS = Rational(4, 3)
N_CHAN, L, OV = 256, 256, 48
GEOM = geometry.SynthesisGeometry(N_CHAN, L, OV, OS)
KPOS = (L // 2 + GEOM.discard) % L
N, LO, ROLL = GEOM.output_fft_length, GEOM.output_overlap, GEOM.fn_width // 2
GAIN = OS.de / OS.nu
ANALYSIS_TOL = 8e-6
SYNTHESIS_TOL = 1.2e-5
PADDED_TOL = 1e-5    # tests/test_pallas.py:268, the padded analysis
BIG_IFFT_TOL = 1e-4  # tests/test_pallas.py:423, the out-of-core IFFT


@pytest.fixture(scope="module")
def filt():
    return fir.design_pfb_fir_filter(N_CHAN, OS, 12)


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's Pallas functions, imported here so that the card
    tests run where JAX is not installed (pytest --noconftest -m cuda)."""
    from ska_pst_dsp_tpu.ops.pallas import (
        analysis_fused, ifft_big, ifft_fused, synthesis_fused,
    )

    return analysis_fused, synthesis_fused, ifft_fused, ifft_big


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


# ---------------------------------------------------------------------------
# numpy emulation of csrc/fft_reg.cuh and the kernels
# ---------------------------------------------------------------------------

def emu_padded_fold(x, f2d_rev, step, slots=3, tiles=None):
    """padded_fold_kernel on ``slots`` persistent blocks. Unit u (column
    group fastest, then run, then polarization) holds its run's rows in
    stream order: slot i is stream row S*k_run - D*phases + i. Step n (one
    tile) waits for barrier n & 1 at parity (n >> 1) & 1; the boxes of step
    n + 1 are issued before step n folds unless they are the next unit's
    first and this tile's window still covers the buffer's start. Tile 0
    loads slots [0, window_pad), tile t > 0 the ``slide`` slots after those
    loaded before it, as boxes of box_rows rows x C columns of the tensor
    (column, row < n_dat // W, polarization): rows outside it arrive as
    zeros and count on the barrier like the others. The fold is the
    residue-class one at the geometries of apf.SPECIALISED and direct
    elsewhere.

    Checked on the way: every box lies in the buffer on 128 bytes; each
    barrier expects the bytes of its boxes; no box touches the window being
    folded; every slot a tile reads was loaded for this unit's stream row,
    exactly once. Returns the output (NaN where nothing was stored) and the
    counts of rows {"copied", "before", "past", "advance"} (loaded from the
    stream, zeros before its start, zeros past its last whole row, and the
    rows the stored spectra advance by)."""
    n_pol, n_dat = x.shape
    phases, block = f2d_rev.shape
    p = apf.plan(block, step, phases)
    kt, ct = apf.K_TILE, apf.C_TILE
    nblocks, n_rows = n_dat // step, n_dat // p.w
    n_cg = p.w // ct
    if tiles is None:
        tiles = apf.seg_tiles(p, nblocks, n_pol * n_cg, slots)
    assert 1 <= tiles <= p.max_tiles and p.slide % p.box_rows == 0
    assert p.box_rows <= apf.BOX_ROWS and 2 * ct <= 256  # the engine's box limits
    assert apf.smem_bytes(block, step, phases, tiles) <= SMEM_LIMIT
    n_seg = -(-(-(-nblocks // kt)) // tiles)
    n_units = n_pol * n_seg * n_cg
    buf_rows = p.window_pad + p.slide * (tiles - 1)
    assert apf.smem_bytes(block, step, phases, tiles) == apf.HEADER + buf_rows * ct * 8
    special = (phases, p.s, p.d) in apf.SPECIALISED
    f3 = f2d_rev.reshape(phases, p.d, p.w)
    out = np.full((n_pol, nblocks, p.d, p.w), np.nan, np.complex64)
    counts = {"copied": 0, "before": 0, "past": 0, "advance": 0}
    d_i, c_i = np.arange(p.d)[:, None], np.arange(ct)[None, :]

    def unit_of(u):
        cg, rest = u % n_cg, u // n_cg
        seg, pol = rest % n_seg, rest // n_seg
        k_run = seg * tiles * kt
        return dict(id=u, pol=pol, c0=cg * ct, k_run=k_run,
                    tiles=min(tiles, -(-(nblocks - k_run) // kt)),
                    r0=p.s * k_run - p.d * phases)

    for blk in range(min(slots, n_units)):
        buf = np.full((buf_rows, ct), np.nan, np.complex64)
        tag = np.full((buf_rows, 2), -1, np.int64)  # (unit, stream row) of each slot
        writes = {}
        done = [0, 0]  # completed phases of the two barriers

        def issue(u, t, bar, live):
            lo = 0 if t == 0 else p.window_pad + p.slide * (t - 1)
            hi = p.window_pad + p.slide * t
            assert hi <= buf_rows and (hi - lo) % p.box_rows == 0
            assert live is None or hi <= live[0] or lo >= live[1]
            expect, copied = (hi - lo) * ct * 8, 0
            for slot in range(lo, hi, p.box_rows):
                assert (apf.HEADER + slot * ct * 8) % 128 == 0
                r = u["r0"] + slot + np.arange(p.box_rows)
                inside = (r >= 0) & (r < n_rows)
                src = np.clip(r, 0, n_rows - 1)[:, None] * p.w + u["c0"] + c_i
                buf[slot:slot + p.box_rows] = np.where(inside[:, None], x[u["pol"]][src], 0)
                copied += p.box_rows * ct * 8
                counts["copied"] += int(inside.sum())
                counts["before"] += int((r < 0).sum())
                counts["past"] += int((r >= n_rows).sum())
            assert copied == expect and expect < 2 ** 20  # the barrier's tx-count range
            for slot in range(lo, hi):
                tag[slot] = (u["id"], u["r0"] + slot)
                writes[(u["id"], slot)] = writes.get((u["id"], slot), 0) + 1
            done[bar] += 1

        unit, t, n = blk, 0, 0
        u = unit_of(unit)
        issue(u, 0, 0, None)
        while unit < n_units:
            nxt_unit, nxt_t = (unit, t + 1) if t + 1 < u["tiles"] else (unit + slots, 0)
            has_next = nxt_unit < n_units
            nu = unit_of(nxt_unit) if has_next and nxt_t == 0 else u
            base = p.slide * t
            early = has_next and (nxt_t > 0 or base >= p.window_pad)
            if early:
                issue(nu, nxt_t, (n + 1) & 1, (base, base + p.window))
            assert done[n & 1] == (n >> 1) + 1  # the wait's parity is this phase's
            sl = slice(base, base + p.window)
            assert (tag[sl, 0] == unit).all()
            assert (tag[sl, 1] == u["r0"] + np.arange(sl.start, sl.stop)).all()
            k0 = u["k_run"] + t * kt
            kv = min(kt, nblocks - k0)
            taps = f3[:, :, u["c0"]:u["c0"] + ct]
            acc = np.zeros((kt, p.d, ct), np.complex64)
            if special:
                u_n = kt // p.d
                n_row = p.s * (u_n - 1) + phases
                for rho in range(p.d):
                    i = np.arange(n_row)[:, None, None]
                    v = buf[base + p.s * rho + d_i[None] + p.d * i, c_i[None]]
                    for q in range(u_n):
                        acc[rho + p.d * q] = (taps * v[p.s * q:p.s * q + phases]).sum(0)
            else:
                kk = np.arange(kt)[:, None, None]
                for m in range(phases):
                    acc += taps[m][None] * buf[base + p.s * kk + p.d * m + d_i[None], c_i[None]]
            out[u["pol"], k0:k0 + kv, :, u["c0"]:u["c0"] + ct] = acc[:kv]
            counts["advance"] += p.s * kv
            if has_next and not early:
                issue(nu, nxt_t, (n + 1) & 1, None)
            unit, t, u, n = nxt_unit, nxt_t, nu, n + 1
        assert set(writes.values()) <= {1}
    return out.reshape(n_pol, nblocks, block), counts


def _dft_matrix(rad, sign=1):
    """W[m, d] = exp(sign*2*pi*i*m*d/rad), complex64: the register radices."""
    m = np.arange(rad)
    return twiddle_table(rad, sign)[(m[:, None] * m[None, :]) % rad]


def _rev8(t, ndig):
    """t with its ndig base-8 digits reversed (csrc/fft_reg.cuh fft_reg_rev8)."""
    t = np.asarray(t)
    r = np.zeros_like(t)
    for _ in range(ndig):
        r = (r << 3) | (t & 7)
        t = t >> 3
    return r


def emu_radix_step(v, tw, q):
    """The radix-R step of csrc/ifft_big.cu on v[..., alpha, beta]
    (point beta + q*alpha): the direct R-point DFT over alpha with
    w_R^x = tw[x*q], then the twiddle tw[beta*kr]; out [..., kr, beta]."""
    r = v.shape[-2]
    a = np.arange(r)
    y = np.einsum("...ab,ak->...kb", v, tw[((a[:, None] * a[None, :]) % r) * q])
    return y * tw[a[:, None] * np.arange(q)[None, :]]


def emu_fft_reg(rows, tab, n_tab, sign=1):
    """csrc/fft_reg.cuh on rows [..., Q], Q = 2^k up to 4096: radix-8 DIF
    passes of span Q/8, Q/64, ... in place, butterfly (g, j) reading
    x[g*L + m*h + j] and writing output d times tab[j*d*(n_tab/L)],
    L = 8h; then the last pass of radix Q/8^(P-1), whose butterfly g holds
    output k = rev8(g) + 8^(P-1)*d in register d. ``tab`` and the radix
    constants have sign ``sign``. Returns [..., Q] in natural order of k."""
    q = rows.shape[-1]
    passes, last = reg_plan(q)
    y = rows.astype(np.complex64)
    for s in range(passes - 1):
        h = q >> (3 * (s + 1))
        v = y.reshape(*y.shape[:-1], q // (8 * h), 8, h)  # [g, m, j]
        out = np.einsum("...gmj,md->...gdj", v, _dft_matrix(8, sign))
        tw = tab[np.arange(8)[:, None] * np.arange(h)[None, :] * (n_tab // (8 * h))]
        y = (out * tw).reshape(y.shape)
    span = q // last
    out = y.reshape(*y.shape[:-1], span, last) @ _dft_matrix(last, sign)  # [g, d]
    g, d = np.arange(span)[:, None], np.arange(last)[None, :]
    k = (_rev8(g, passes - 1) + span * d).ravel()
    res = np.empty_like(y)
    res[..., k] = out.reshape(*y.shape[:-1], q)
    return res


def _reg_passes(buf, phys, q, tab, first, sign=-1):
    """The radix-8 passes s >= first of the new kernels on buf [..., Q]
    (stored at phys(p)), twiddles from the per-pass table ``tab``
    (csrc/fft_reg.cuh fft_reg_pass_tw) of sign ``sign``."""
    passes, _ = reg_plan(q)
    per = q // 8
    u = np.arange(per)
    for s in range(first, passes - 1):
        h = q >> (3 * (s + 1))
        grp, j = u // h, u % h
        pos = (grp * 8 * h + j)[:, None] + h * np.arange(8)[None, :]  # [u, m]
        w = buf[..., phys[pos]] @ _dft_matrix(8, sign)  # [..., u, d]
        tw = tab[(q - (q >> (3 * s))) + (np.arange(1, 8)[None, :] - 1) * h + j[:, None]]
        w[..., 1:] *= np.where(j[:, None] != 0, tw, np.complex64(1))
        buf[..., phys[pos]] = w
    return buf


def _last_pass(buf, phys, q, sign=-1):
    """The last pass: thread tq takes butterfly rev8(tq); returns [..., tq, d]
    holding bin tq + (Q/r_last)*d."""
    passes, last = reg_plan(q)
    span = q // last
    base = _rev8(np.arange(span), passes - 1) * last
    return buf[..., phys[base[:, None] + np.arange(last)[None, :]]] @ _dft_matrix(last, sign)


def chan_phys(logq):
    """csrc/chan_dft_fused.cu chan_phys over [0, Q)."""
    p = np.arange(1 << logq)
    return p ^ (((p >> (logq - 3)) & 7) | (((p >> 6) & 1) << 3))


def frontend_phys(logl):
    """csrc/fft_reg.cuh fft_reg_swizzle over [0, L), the row layout of the
    frontend and the analysis."""
    p = np.arange(1 << logl)
    a = (p >> (logl - 3)) & 7
    last = reg_plan(1 << logl)[1]
    sw = {8: a, 4: (a & 3) | ((a & 4) << 1), 2: (a & 1) | ((a & 6) << 1)}[last]
    return p ^ sw


def emu_chan_dft(g, const, block0, delay):
    """chan_dft_kernel: tiles of 4096 / block spectra; r = 1 loads the first
    radix-8 pass's points g[k, j + m*Q/8] straight into registers, r = 3
    runs the radix-3 step first; the per-pass twiddle table; swizzled
    shared-memory rows; the last pass stored from registers at channel
    kr + r*(tq + SPAN*d), times the constant row (k + block0) % nu, to row
    (k - delay) mod nb."""
    n_pol, nb, block = g.shape
    r, logq = cdf.kernel_split(block)
    q = 1 << logq
    per = q // 8
    spec = cdf.POINTS // block
    phys = chan_phys(logq)
    assert np.array_equal(np.sort(phys), np.arange(q))
    tab = pass_twiddles(q, -1)
    n_spec = n_pol * nb
    n_tiles = -(-n_spec // spec)
    flat = np.zeros((n_tiles * spec, block), np.complex64)
    flat[:n_spec] = g.reshape(n_spec, block)
    flat = flat.reshape(n_tiles, spec, block)
    buf = np.zeros((n_tiles, spec * r, q), np.complex64)
    if r == 1:
        j = np.arange(per)
        v = flat[..., j[:, None] + per * np.arange(8)[None, :]] @ _dft_matrix(8, -1)
        tw = tab[(np.arange(1, 8)[None, :] - 1) * per + j[:, None]]
        v[..., 1:] *= np.where(j[:, None] != 0, tw, np.complex64(1))
        buf[..., phys[j[:, None] + per * np.arange(8)[None, :]]] = v
        first = 1
    else:
        beta = np.arange(q)
        twn = twiddle_table(block, -1)
        u = flat.reshape(n_tiles, spec, r, q).transpose(0, 1, 3, 2) @ _dft_matrix(r, -1)
        u = u * twn[beta[:, None] * np.arange(r)[None, :]]  # [tile, si, beta, kr]
        buf[..., phys] = u.transpose(0, 1, 3, 2).reshape(n_tiles, spec * r, q)
        first = 0
    buf = _reg_passes(buf, phys, q, tab, first)
    w = _last_pass(buf, phys, q)  # [tile, row, tq, d]
    span, last = w.shape[-2:]
    kq = np.arange(span)[:, None] + span * np.arange(last)[None, :]
    y = np.empty((n_tiles, spec, block), np.complex64)
    rows = w.reshape(n_tiles, spec, r, span, last)
    for kr in range(r):
        y[..., kr + r * kq] = rows[:, :, kr]
    y = y.reshape(-1, block)[:n_spec].reshape(n_pol, nb, block)
    k = np.arange(nb)
    out = np.full_like(y, np.nan)
    out[:, (k - delay) % nb] = y * const[(k + block0 % const.shape[0]) % const.shape[0]]
    return out


def emu_frontend(flat, strides, shape, taper, dr, perm, keep, kpos, n_blocks):
    """synthesis_frontend_kernel: tiles of one block b and 32 channels; the
    first pass's samples loaded strided from a flat buffer (perm[c] once
    per lane), tapered, radix-8 DFT and twiddle into swizzled rows of
    L + 1 points; the middle radix-8 pass; the last pass on bins, storing
    only j = (tq + SPAN*d - kpos) mod L < FN_width, times dr[j]."""
    sp, st, sc = strides
    n_pol, _, n_chan = shape
    n_l, fnw = taper.size, dr.size
    logl = tsf.LENGTHS[n_l]
    per = n_l // 8
    phys = frontend_phys(logl)
    assert np.array_equal(np.sort(phys), np.arange(n_l))
    tab = pass_twiddles(n_l, -1)
    n_ct = -(-n_chan // 32)
    c = np.arange(n_ct * 32)
    pc = np.where(c < n_chan, perm[np.minimum(c, n_chan - 1)], 0)
    j = np.arange(per)
    t = j[:, None] + per * np.arange(8)[None, :]  # [j, m]
    p, b = np.arange(n_pol), np.arange(n_blocks)
    idx = (p[:, None, None, None, None] * sp
           + (b[None, :, None, None, None] * keep + t[None, None, None]) * st
           + pc[None, None, :, None, None] * sc)  # [p, b, c, j, m]
    v = np.where((c < n_chan)[None, None, :, None, None], flat[idx], 0).astype(np.complex64)
    v = (v * taper[t]) @ _dft_matrix(8, -1)
    tw = tab[(np.arange(1, 8)[None, :] - 1) * per + j[:, None]]
    v[..., 1:] *= np.where(j[:, None] != 0, tw, np.complex64(1))
    buf = np.zeros((n_pol, n_blocks, n_ct * 32, n_l), np.complex64)
    buf[..., phys[t]] = v
    buf = _reg_passes(buf, phys, n_l, tab, 1)
    w = _last_pass(buf, phys, n_l)  # [p, b, c, tq, d]
    span, last = w.shape[-2:]
    jj = (np.arange(span)[:, None] + span * np.arange(last)[None, :] - kpos) % n_l
    kept = jj < fnw
    out = np.full((n_pol, n_blocks, n_ct * 32, fnw), np.nan, np.complex64)
    out[..., jj[kept]] = w[..., kept] * dr[jj[kept]]
    return out[:, :, :n_chan]


def ana_fold_geometry(block, step, phases):
    """(SB, BB) of the residue-class fold the kernel specialises (the low
    geometry: block 256, 13 phases, hop 192 -> 3 blocks per 4 spectra), or
    None where it folds directly (csrc/analysis_fused.cu pick_kernel)."""
    if (block, phases, step) == (256, 13, 192):
        g = math.gcd(step, block)
        return step // g, block // g
    return None


def span_chunk(nbytes):
    """Bytes each lane of the issuing warp copies (csrc/analysis_fused.cu
    span_chunk)."""
    return (((nbytes + 31) >> 5) + 15) & ~15


def emu_analysis(x, f2d, ramp, step, block0, bins=None):
    """analysis_fused_kernel: tiles of tile_spectra(block) spectra of one
    polarization; each tile's span copied from the flat stream starting at
    the 16-byte-aligned sample at or before it (offset o), NaN past the
    stream (no stored spectrum reads it); the fold (the residue-class window
    at the low geometry: class r of column j reads rows r*step + i*block,
    i < SB*(U-1) + phases, once each and adds row i to spectrum r + BB*u at
    phase i - SB*u; directly elsewhere); the folded point j of spectrum kk
    at sub-row kk*R + j//Q, position fft_reg_swizzle(j % Q); the radix-R step; the
    radix-8 passes; the last pass in channel order kr + R*(tq + SPAN*d)
    times the ramp row (k + block0) % period and the block, stored for
    k < nblocks only. Returns the output, NaN where nothing was stored.

    Given ``bins`` (r = 1), the channel-major store: the last pass's
    products staged as a (bin, spectrum) tile of stride k_t + 1 (lane
    (kk, tq) writes bins tq + SPAN*d of spectrum kk), then output row i of
    the tile's spectra read from bin bins[i], lanes on spectra, stored for
    k < nblocks only: (n_pol, len(bins), nblocks)."""
    n_pol, n_dat = x.shape
    phases, block = f2d.shape
    r, q, logq = radix(block)
    k_t = af.tile_spectra(block)
    nblocks = (n_dat - phases * block) // step
    span = (k_t - 1) * step + phases * block
    phys = frontend_phys(logq)
    tab = pass_twiddles(q, -1)
    twn = twiddle_table(block, -1)
    period = ramp.shape[0]
    flat = x.ravel()
    n_kt = -(-nblocks // k_t)
    fold_geom = ana_fold_geometry(block, step, phases)
    out = np.full((n_pol, nblocks, block), np.nan, np.complex64)
    if bins is not None:
        out = np.full((n_pol, len(bins), nblocks), np.nan, np.complex64)
    j = np.arange(block)
    for tile in range(n_pol * n_kt):
        pol, kt = divmod(tile, n_kt)
        s0 = kt * k_t * step
        e0 = pol * n_dat + s0
        o = e0 & 1
        nv = min(span, n_dat - s0) + o
        buf = np.full(span + 1, np.nan, np.complex64)
        nbytes = nv * 8 // 16 * 16
        chunk = span_chunk(nbytes)
        for lane in range(32):  # the issuing warp's copies, 8-byte samples
            a, b = lane * chunk, min(nbytes, (lane + 1) * chunk)
            if a < b:
                buf[a // 8: b // 8] = flat[e0 - o + a // 8: e0 - o + b // 8]
        if nbytes < nv * 8:  # an odd last sample, loaded by lane 0
            buf[nv - 1] = flat[e0 - o + nv - 1]
        src = buf[o:]
        fold = np.zeros((k_t, block), np.complex64)
        if fold_geom is not None:
            sb, bb = fold_geom
            u_n = k_t // bb
            for cls in range(bb):
                for i in range(sb * (u_n - 1) + phases):
                    v = src[cls * step + i * block + j]
                    for u in range(u_n):
                        m = i - sb * u
                        if 0 <= m < phases:
                            fold[cls + bb * u] += f2d[m] * v
        else:
            for kk in range(k_t):
                for m in range(phases):
                    fold[kk] += f2d[m] * src[kk * step + m * block + j]
        rows = np.zeros((k_t * r, q), np.complex64)
        rows[(np.arange(k_t)[:, None] * r + j[None, :] // q), phys[j % q][None, :]] = fold
        if r > 1:
            beta = np.arange(q)
            v = rows.reshape(k_t, r, q)[:, :, phys[beta]]  # [kk, a, beta]
            y = np.einsum("kab,ad->kdb", v, _dft_matrix(r, -1))
            y = y * twn[beta[None, :] * np.arange(r)[:, None]][None]
            rows.reshape(k_t, r, q)[:, :, phys[beta]] = y
        rows = _reg_passes(rows, phys, q, tab, 0)
        w = _last_pass(rows, phys, q)  # [sr, tq, d]
        spn, last = w.shape[-2:]
        ch = (np.arange(r)[:, None, None]
              + r * (np.arange(spn)[None, :, None] + spn * np.arange(last)[None, None, :]))
        spec = np.empty((k_t, block), np.complex64)
        spec[:, ch.ravel()] = w.reshape(k_t, r * spn * last)
        kk = np.arange(k_t)
        if bins is not None:
            assert r == 1
            ldk = k_t + 1
            prod = spec * ramp[(kt * k_t + kk + block0 % period) % period] * np.float32(block)
            stage = np.full(block * ldk, np.nan, np.complex64)
            kq, tq, d = np.ix_(kk, np.arange(spn), np.arange(last))
            stage[(tq + spn * d) * ldk + kq] = prod[kq, tq + spn * d]
            i, kq = np.ix_(np.arange(len(bins)), kk)
            keep = np.broadcast_to(kt * k_t + kq < nblocks, (len(bins), k_t))
            dst = np.broadcast_to(kt * k_t + kq, keep.shape)
            out[pol, np.broadcast_to(i, keep.shape)[keep], dst[keep]] = (
                stage[np.asarray(bins)[i] * ldk + kq][keep])
            continue
        keep = kt * k_t + kk < nblocks
        k_abs = kt * k_t + kk[keep]
        out[pol, k_abs] = (spec[keep] * ramp[(k_abs + block0 % period) % period]
                           * np.float32(block))
    return out


def emu_8xg(v, tw_pass, sign=1):
    """The cluster kernel's transform of v [..., Q], Q = 8*G in {64, 128}:
    the radix-8 pass of span G (butterfly j reads points j + G*m, output d
    times w_Q^(j*d) = the 128-point per-pass table's entry
    (d - 1)*16 + (16/G)*j, to point j + G*d), then the G-point DFT of each
    group d in registers. Returns [..., d, k] holding output d + 8*k."""
    g = v.shape[-1] // 8
    x = v.reshape(*v.shape[:-1], 8, g)  # [m, j]
    y = np.einsum("...mj,md->...dj", x, _dft_matrix(8, sign))
    j, d = np.arange(g)[None, :], np.arange(8)[:, None]
    tw = np.where((j == 0) | (d == 0), np.complex64(1),
                  tw_pass[((d - 1) * 16 + (16 // g) * j) % 112])
    return (y * tw) @ _dft_matrix(g, sign)  # [..., d, k]


def emu_cluster_epilogue(X, elem, n, lo, roll, gain, n_valid):
    """ifft_cluster_kernel on each transform, the CL blocks of a cluster
    (itf.PLANS: n1 = r1 * q1, q1 = 8*G): block c's columns m1 in
    [c*n1/CL, (c+1)*n1/CL) of all 128 rows (the bulk copies, each a whole
    number of 16 bytes from a 16-byte offset), times elem; the 128-point
    transforms over m2 (emu_8xg, sign +1); output k2 = d + 8*k of group d
    times tw_a[k2 // 16, m1] * tw_b[k2 % 16, m1], written to row
    k2 % (128/CL) of block k2 // (128/CL)'s receive buffer (each slot
    exactly once); each block's rows, m1 = j + G*m + q1*alpha: the radix-r1
    DFT over alpha times w_n1^((j + G*m)*kr), then emu_8xg over (m, j) of
    each sub-row kr; the kept k1 = kr + r1*(d + 8*k) only, times
    roll_row[k2] * gain/N * roll_col[k1], at t - lo = k2 + 128*(k1 - k1_lo).
    Returns the output (NaN where nothing was stored) and the count of
    stores per sample."""
    n2 = itf.N2
    n1 = n // n2
    r1, q1, cl = itf.PLANS[n1]
    assert r1 * q1 == n1
    cpc, rows = n1 // cl, n2 // cl
    assert cpc * cl == n1 and (cpc * 8) % 16 == 0  # whole, aligned bulk copies
    tab = itf.cluster_tables(n, n1, roll % n)
    k1_lo, n1_keep = lo // n2, (n - 2 * lo) // n2
    n_pol = X.shape[0]
    out = np.full((n_pol, n_valid, n - 2 * lo), np.nan, np.complex64)
    stores = np.zeros(out.shape, np.int64)
    dk16 = np.arange(8)[:, None] + 8 * np.arange(16)[None, :]  # [d, k]: d + 8*k
    dk = np.arange(8)[:, None] + 8 * np.arange(q1 // 8)[None, :]
    for p in range(n_pol):
        for b in range(n_valid):
            w = X[p, b] if elem is None else X[p, b] * elem
            recv = np.full((cl, rows, n1), np.nan, np.complex64)
            for c in range(cl):
                m1 = c * cpc + np.arange(cpc)
                col = np.ascontiguousarray(w.reshape(n2, n1)[:, m1].T)  # [c, m2]
                y = emu_8xg(col, tab["tw_pass"])  # [c, d, k]
                k2 = dk16.ravel()
                tw = tab["tw_a"][k2 >> 4][:, m1] * tab["tw_b"][k2 & 15][:, m1]  # [k2, c]
                blk, kl = k2 // rows, k2 % rows
                assert np.isnan(recv[blk[:, None], kl[:, None], m1[None, :]]).all()
                recv[blk[:, None], kl[:, None], m1[None, :]] = y.reshape(cpc, 128).T * tw
            assert not np.isnan(recv).any()  # every slot of every block written
            for blk in range(cl):
                v = recv[blk].reshape(rows, r1, q1)  # [kl, alpha, j + G*m]
                if r1 > 1:
                    v = emu_radix_step(v, tab["tw_n1"], q1)  # [kl, kr, j + G*m]
                y = emu_8xg(v, tab["tw_pass"])  # [kl, kr, d, k]
                k2 = blk * rows + np.arange(rows)
                k1 = np.arange(r1)[:, None, None] + r1 * dk[None]  # [kr, d, k]
                kept = (k1 >= k1_lo) & (k1 < k1_lo + n1_keep)
                t = k2[:, None] + n2 * (k1[kept] - k1_lo)[None, :]
                ph = ((tab["roll_row"][k2] * np.float32(gain / n))[:, None]
                      * tab["roll_col"][k1[kept]][None, :])
                out[p, b, t] = y[:, kept] * ph
                np.add.at(stores[p, b], t.ravel(), 1)
    return out, stores


def emu_radix6_passes(v, tw_col):
    """csrc/inversion_fused.cu's 216-point column transform of v [..., 216]
    (sign +1): the radix-6 passes of span h = 36 and 6 in place (butterfly
    j of group g reads point 6h*g + j + h*m, writes output d times
    tw_col[off_h + (d - 1)*h + j] to 6h*g + j + h*d; off_36 = 0,
    off_6 = 180), then the last radix-6 DFT of butterfly g over points
    6*g + m. Returns [..., g, d] holding output k2 = g//6 + 6*(g%6) + 36*d."""
    y = v.astype(np.complex64)
    off = 0
    for h in (36, 6):
        x = y.reshape(*y.shape[:-1], 216 // (6 * h), 6, h)  # [g, m, j]
        out = np.einsum("...gmj,md->...gdj", x, _dft_matrix(6, 1))
        j, d = np.arange(h)[None, :], np.arange(6)[:, None]
        tw = np.where((j == 0) | (d == 0), np.complex64(1),
                      tw_col[(off + (d - 1) * h + j) % tw_col.size])
        y = (out * tw).reshape(y.shape)
        off += 5 * h
    return y.reshape(*y.shape[:-1], 36, 6) @ _dft_matrix(6, 1)


def emu_inversion_epilogue(X, elem, n, lo, n_valid):
    """inversion_fused_kernel's epilogue on the assembled blocks X, on the
    split (n2, n1) of inv.GEOMETRIES and the tables of inv.kernel_tables,
    eight blocks: block c's columns m1 in [c*n1/8, (c+1)*n1/8), times elem;
    the n2-point transforms over m2 (128: emu_8xg, output k2 = d + 8*k;
    216: emu_radix6_passes); each output times tw_a[k2 // S, m1] *
    tw_b[k2 % S, m1] written to row k2 % (n2/8) of block k2 // (n2/8)'s
    receive buffer, each slot exactly once; each block's rows,
    m1 = j + G*m + q1*alpha with n1 = 3 * q1: the radix-3 DFT over alpha
    times w_n1^((j + G*m)*kr), then emu_8xg over (m, j) of each sub-row kr
    on the 128-point table; the kept k1 = kr + 3*(d + 8*k) only, with no
    phase or gain, at t - lo = k2 + n2*(k1 - k1_lo). Returns the output
    (NaN where nothing was stored) and the count of stores per sample."""
    (n2, n1), = {s for g, s in inv.GEOMETRIES.items() if g[2] == n}
    cl, r1, q1, s = 8, 3, n1 // 3, inv.TW_SPLIT[n2]
    cpc, rows = n1 // cl, n2 // cl
    tab = inv.kernel_tables(n, n2, n1)
    k1_lo, n1_keep = lo // n2, (n - 2 * lo) // n2
    if n2 == 128:  # [d, k]: output d + 8*k
        k2 = (np.arange(8)[:, None] + 8 * np.arange(16)[None, :]).ravel()
    else:          # [g, d]: output g//6 + 6*(g%6) + 36*d
        g = np.arange(36)
        k2 = ((g // 6 + 6 * (g % 6))[:, None] + 36 * np.arange(6)[None, :]).ravel()
    dk = np.arange(8)[:, None] + 8 * np.arange(q1 // 8)[None, :]
    n_pol = X.shape[0]
    out = np.full((n_pol, n_valid, n - 2 * lo), np.nan, np.complex64)
    stores = np.zeros(out.shape, np.int64)
    for p in range(n_pol):
        for b in range(n_valid):
            w = X[p, b] if elem is None else X[p, b] * elem
            recv = np.full((cl, rows, n1), np.nan, np.complex64)
            for c in range(cl):
                m1 = c * cpc + np.arange(cpc)
                col = np.ascontiguousarray(w.reshape(n2, n1)[:, m1].T)  # [c, m2]
                y = (emu_8xg(col, tab["tw_col"]) if n2 == 128
                     else emu_radix6_passes(col, tab["tw_col"]))
                tw = tab["tw_a"][k2 // s][:, m1] * tab["tw_b"][k2 % s][:, m1]  # [k2, c]
                blk, kl = k2 // rows, k2 % rows
                assert np.isnan(recv[blk[:, None], kl[:, None], m1[None, :]]).all()
                recv[blk[:, None], kl[:, None], m1[None, :]] = y.reshape(cpc, n2).T * tw
            assert not np.isnan(recv).any()  # every slot of every block written
            for blk in range(cl):
                v = recv[blk].reshape(rows, r1, q1)  # [kl, alpha, j + G*m]
                v = emu_radix_step(v, tab["tw_n1"], q1)  # [kl, kr, j + G*m]
                y = emu_8xg(v, tab["tw_row"])  # [kl, kr, d, k]
                k2r = blk * rows + np.arange(rows)
                k1 = np.arange(r1)[:, None, None] + r1 * dk[None]  # [kr, d, k]
                kept = (k1 >= k1_lo) & (k1 < k1_lo + n1_keep)
                t = k2r[:, None] + n2 * (k1[kept] - k1_lo)[None, :]
                out[p, b, t] = y[:, kept]
                np.add.at(stores[p, b], t.ravel(), 1)
    return out, stores


def emu_frame_load(x, held, perm, keep, n_blocks, n_l):
    """inversion_fused.cu frame_load: each input a (flat buffer, (n_pol, n,
    n_chan), element strides (sp, st, sc)), ``held`` None (h = 0) or the h
    samples that come before x. Frame b of stream p, channel c: the samples
    t = b*keep + [0, L) of the stream of held's h samples then x's; a frame
    wholly before the seam reads held at p*hp + t*ht + perm[c]*hc, one
    wholly after it x at p*sp + (t - h)*st + perm[c]*sc (every frame at
    h = 0), one across it each sample from its own side. Returns the frames
    [p, b, t, c] and each frame's side (0 held, 1 x, 2 across)."""
    flat_x, (n_pol, n_dat, n_chan), (sp, st, sc) = x
    flat_h, h, (hp, ht, hc) = (None, 0, (0, 0, 0)) if held is None else (
        held[0], held[1][1], held[2])
    assert held is None or (held[1][0], held[1][2]) == (n_pol, n_chan)
    assert (n_blocks - 1) * keep + n_l <= h + n_dat
    p = np.arange(n_pol)[:, None, None]
    ch = perm.astype(np.int64)[None, None, :]
    frames, sides = np.empty((n_pol, n_blocks, n_l, n_chan), np.complex64), []
    for b in range(n_blocks):
        t = (b * keep + np.arange(n_l))[None, :, None]
        if b * keep + n_l <= h:
            frames[:, b], side = flat_h[p * hp + t * ht + ch * hc], 0
        elif b * keep >= h:
            frames[:, b], side = flat_x[p * sp + (t - h) * st + ch * sc], 1
        else:
            from_h = flat_h[p * hp + np.minimum(t, h - 1) * ht + ch * hc]
            from_x = flat_x[p * sp + np.maximum(t - h, 0) * st + ch * sc]
            frames[:, b], side = np.where(t < h, from_h, from_x), 2
        sides.append(side)
    return frames, sides


def emu_inversion_fused(x, taper, dr, perm, elem, keep, kpos, n_blocks, lo, roll, gain,
                        held=None):
    """inversion_fused_kernel on a (n_pol, n_dat, n_chan) stream, read by
    :func:`emu_frame_load` (``x`` and ``held`` as there), at one of
    inv.GEOMETRIES (L = 256): block r of the cluster is the frontend of
    channels [C*r, C*r + C), C = n_chan / 8, in halves of 16 and C - 16
    (lane c of a half < 16 channels stores nothing past its last), each
    channel as 16 * 16 (t = j + 16*m: taper, the 16-point DFT over m, times
    w_L^(j*d) from the exact table; then the 16-point DFT over j: bin
    d + 16*e); each kept bin j' = (k - kpos) mod L < 192, times
    dr[j'] * gain/N, goes to k' = (192*c + j' - roll) mod N, row k' // n1
    of the column buffer of block (k' % n1) // (n1/8), each slot of each
    block exactly once; then emu_inversion_epilogue on the gathered block
    with elem read at the unshifted bin k' + roll and no roll phase or gain
    left. Returns the output and the count of stores per sample."""
    n_pol, _, n_chan = x[1]
    n_l, fnw, cl = taper.size, dr.size, 8
    n = n_chan * fnw
    n2, n1 = inv.GEOMETRIES[(n_l, n_chan, n)]
    cpc, per = n1 // cl, n_chan // cl
    # the blocks' halves take every channel once
    halves = [r * per + h * 16 + np.arange(min(16, per - 16 * h))
              for r in range(cl) for h in range(2)]
    assert np.array_equal(np.sort(np.concatenate(halves)), np.arange(n_chan))
    t = np.arange(n_l)
    frames, _ = emu_frame_load(x, held, perm, keep, n_blocks, n_l)
    v = (frames.transpose(0, 1, 3, 2) * taper).astype(np.complex64)  # [p, b, c, t]
    v = v.reshape(n_pol, n_blocks, n_chan, 16, 16)  # [.., m, j]
    a = np.einsum("...mj,md->...jd", v, _dft_matrix(16, -1))
    jd = np.arange(16)[:, None] * np.arange(16)[None, :]
    a = a * twiddle_table(n_l, -1)[jd]
    y = np.einsum("...jd,je->...ed", a, _dft_matrix(16, -1)).reshape(
        n_pol, n_blocks, n_chan, n_l)  # bin 16*e + d
    jk = (t - kpos) % n_l
    kept = jk < fnw
    scale = np.float32(gain / n)
    cols = np.zeros((n_pol, n_blocks, cl, n // n1, cpc), np.complex64)
    stores = np.zeros(cols.shape, np.int64)
    c = np.arange(n_chan)[:, None]
    k = (fnw * c + jk[kept][None, :] - roll) % n  # [c, kept bin]
    m2, m1 = k // n1, k % n1
    cols[:, :, m1 // cpc, m2, m1 % cpc] = y[..., kept] * (dr[jk[kept]] * scale)
    np.add.at(stores, (slice(None), slice(None), m1 // cpc, m2, m1 % cpc), 1)
    assert (stores == 1).all()  # every column slot of every block written once
    flat = cols.transpose(0, 1, 3, 2, 4).reshape(n_pol, n_blocks, n)
    e = None if elem is None else np.roll(elem, -roll)
    return emu_inversion_epilogue(flat, e, n, lo, n_blocks)


def emu_big_inner(w, n2, n1, tables):
    """ifft_big_inner_kernel on one transform w (N,) = X*elem: A[k2, i1]."""
    r, logq = big.kernel_split(n2)
    q = 1 << logq
    v = w.reshape(n2, n1).T.reshape(n1, r, q)  # [i1, alpha, beta]: i2 = beta + q*alpha
    y = emu_radix_step(v, tables["tw_n2"], q)
    a = emu_fft_reg(y, tables["tw_n2"], n2)  # [i1, kr, kq]: k2 = kr + r*kq
    return a.transpose(2, 1, 0).reshape(n2, n1)


def emu_big_outer(a, n2, n1, lo, tables, scale):
    """ifft_big_outer_kernel on one transform's A: the two-level N-level
    twiddle, the n1-point DFT, the kept k1 times roll_row * scale *
    roll_col, in time order."""
    n = n2 * n1
    r, logq = big.kernel_split(n1, big.OUTER_SPLITS)
    q = 1 << logq
    i1 = np.arange(n1)
    w = tables["row_hi"][:, i1 // big.LANES] * tables["row_lo"][:, i1 % big.LANES]
    v = (a * w).reshape(n2, r, q)
    y = emu_radix_step(v, tables["tw_n1"], q) if r > 1 else v
    z = emu_fft_reg(y, tables["tw_n1"], n1)  # [k2, kr, kq]: k1 = kr + r*kq
    z = z.transpose(0, 2, 1).reshape(n2, n1)  # natural k1
    k1_lo, n1_keep = lo // n2, (n - 2 * lo) // n2
    k1 = k1_lo + np.arange(n1_keep)
    ph = (tables["roll_row"] * np.float32(scale))[:, None] * tables["roll_col"][k1][None, :]
    return (z[:, k1] * ph).T.reshape(-1)  # t - lo = k2 + n2*(k1 - k1_lo)


def emu_ifft_big(X, elem, n2, n1, lo, roll, gain):
    """fused_big_ifft_oc on the card: the inner kernel over every transform
    into A (n_tr, n2, n1), then the outer kernel. Returns A and the output."""
    n = n2 * n1
    tables = big.big_ifft_tables(n, n2, n1, roll % n)
    n_pol, n_b, _ = X.shape
    flat = X.reshape(n_pol * n_b, n)
    w = flat if elem is None else flat * elem
    a = np.stack([emu_big_inner(wt, n2, n1, tables) for wt in w])
    out = np.stack([emu_big_outer(at, n2, n1, lo, tables, gain / n) for at in a])
    return a, out.reshape(n_pol, n_b, n - 2 * lo)


class TestDecomposition:
    def test_radix_split(self):
        assert radix(256) == (1, 256, 8)
        assert radix(384) == (3, 128, 7)
        assert radix(3584) == (7, 512, 9)
        with pytest.raises(ValueError, match="odd factors"):
            radix(320)

    def test_twiddle_table_exact_phase(self):
        tab = twiddle_table(49152, 1)
        m = np.arange(49152)
        ref = np.exp(2j * np.pi * m / 49152)
        assert np.abs(tab - ref).max() < 1e-7

    @pytest.mark.parametrize("block,os_f,taps", [(256, OS, 12), (512, Rational(8, 7), 4),
                                                 (384, OS, 4)])
    @pytest.mark.parametrize("block0", [0, 7])
    def test_analysis_emulation(self, filt, block, os_f, taps, block0):
        # 2.3 tiles per polarization: a ragged last tile; an odd stream
        # length, so the second polarization's spans start one sample early
        step = geometry.analysis_step(block, os_f)
        f = filt if block == N_CHAN else fir.design_pfb_fir_filter(block, os_f, taps)
        f2d = _prep_filter(f, block)
        ramp = ramp_table(block, step)
        k_t = af.tile_spectra(block)
        n_dat = f2d.shape[0] * block + step * (2 * k_t + k_t // 3) + 17
        x = _noise((2, n_dat), 10 + block)
        got = emu_analysis(x, f2d, ramp, step, block0)
        assert not np.isnan(got).any()  # every spectrum's every channel stored
        ref = analysis_core(torch.as_tensor(x), torch.as_tensor(f2d),
                            torch.as_tensor(ramp), step, block0).numpy()
        assert _rel_err(got, ref) < ANALYSIS_TOL

    @pytest.mark.parametrize("geom", ["sps", "lowcbf"])
    def test_analysis_channel_major_emulation(self, geom):
        # the channel-major store's staging and row table at both cascade
        # geometries, over a ragged last tile: exactly the time-major store's
        # spectra, the table's bins, transposed
        f2d, ramp, step = CASCADE_ANALYSIS[geom](np.random.default_rng(66))
        rows = (np.arange(256) if geom == "sps" else lowcbf.kept_bins()).astype(np.int32)
        n_dat = f2d.shape[0] * 256 + step * (2 * 32 + 11) + 17
        x = _noise((2, n_dat), 67)
        got = emu_analysis(x, f2d, ramp, step, 5, rows)
        want = emu_analysis(x, f2d, ramp, step, 5)
        assert got.shape == (2, rows.size, want.shape[1]) and not np.isnan(got).any()
        assert np.array_equal(got, want[:, :, rows].transpose(0, 2, 1))

    @pytest.mark.parametrize("geom", ["sps", "lowcbf"])
    def test_analysis_channel_major_contract(self, geom):
        # row i of the channel-major store is bin rows[i] of every spectrum
        # of the time-major store, contiguous
        f2d, ramp, step = (torch.as_tensor(t) if not isinstance(t, int) else t
                           for t in CASCADE_ANALYSIS[geom](np.random.default_rng(68)))
        rows = torch.as_tensor(np.arange(256) if geom == "sps" else lowcbf.kept_bins(),
                               dtype=torch.int32)
        x = torch.as_tensor(_noise((2, f2d.shape[0] * 256 + step * 75 + 3), 69))
        got = analysis_fused(x, f2d, ramp, step, 5, rows=rows)
        want = analysis_fused(x, f2d, ramp, step, 5)
        assert got.is_contiguous() and got.shape == (2, rows.numel(), want.shape[1])
        assert torch.equal(got, want.index_select(-1, rows).transpose(1, 2))

    def test_analysis_channel_major_plan(self):
        # the store exists for block 256 on the generic fold alone; its
        # (bin, spectrum) tile shares the span buffer, which at both cascade
        # geometries is larger already, and binds only at a short filter
        for args in ((256, 216, 25, 32), (256, 192, 12, 4)):
            assert af.takes(*args, channel_major=True)
            assert af.smem_bytes(*args, 2, True) == af.smem_bytes(*args, 2)
        assert af.smem_bytes(256, 216, 25, 32) == 211_744
        assert not af.takes(256, 192, 13, 4, channel_major=True) and af.takes(256, 192, 13, 4)
        assert not af.takes(512, 448, 12, 8, channel_major=True) and af.takes(512, 448, 12, 8)
        tile, sub_rows = 256 * 33, 32 * 257
        assert (af.smem_bytes(256, 192, 2, 4, 2, True) - af.smem_bytes(256, 192, 2, 4, 2)
                == 2 * (tile - sub_rows) * 8)

    def test_span_chunks_cover(self):
        # the 32 lanes' copies cover every span size, each a multiple of 16
        nbytes = np.arange(16, 300_000, 16)
        chunk = span_chunk(nbytes)
        assert (chunk % 16 == 0).all() and (32 * chunk >= nbytes).all()
        assert (31 * chunk < nbytes + 16 * 32).all()

    def test_analysis_smem_low(self):
        # low: 32 spectra a tile, a 9280-sample span (+1), two buffers, the
        # 4-row ramp staged: 158,880 bytes, one block per SM
        assert af.tile_spectra(256) == 32 and ana_fold_geometry(256, 192, 13) == (3, 4)
        assert af.smem_bytes(256, 192, 13, 4) == 160 + (2 * 9282 + 252) * 8 + 4 * 256 * 8
        assert af.span_stages(256, 192, 13, 4) == 2
        # block 1024 at 8/7 with 12 phases: one buffer only; far larger: none
        assert af.span_stages(1024, 896, 12, 8) == 1
        assert af.span_stages(1024, 896, 40, 8) == 0

    @pytest.mark.parametrize("n_l", [256, 512])
    @pytest.mark.parametrize("combine", [1, 16])
    @pytest.mark.parametrize("layout", ["channel_major", "time_major"])
    def test_frontend_emulation(self, filt, n_l, combine, layout):
        # 48 channels: a full tile of 32 and a ragged one
        n_chan, n_dat = 48, 700
        os_f = OS if n_l == 256 else Rational(8, 7)
        ov = OV if n_l == 256 else 128
        geom = geometry.SynthesisGeometry(n_chan, n_l, ov, os_f)
        kpos = (n_l // 2 + geom.discard) % n_l
        c = tsynth.synthesis_constants(n_chan, n_l, os_f, ov, temporal_taper="tukey",
                                       combine=combine)
        c["dr"] = np.linspace(0.5, 1.5, geom.fn_width).astype(np.float32)
        n_blocks = geom.n_blocks(n_dat)
        if layout == "channel_major":  # strides (C*T, 1, T)
            x = _noise((2, n_chan, n_dat), 11)
            strides, x_tc = (n_chan * n_dat, 1, n_dat), torch.as_tensor(x).transpose(1, 2)
        else:  # strides (T*C, C, 1)
            x = _noise((2, n_dat, n_chan), 11)
            strides, x_tc = (n_dat * n_chan, n_chan, 1), torch.as_tensor(x)
        got = emu_frontend(x.ravel(), strides, (2, n_dat, n_chan), c["t_taper"], c["dr"],
                           c["perm"], geom.input_keep, kpos, n_blocks)
        assert not np.isnan(got).any()  # every kept bin stored once
        ref = tsynth.frontend(
            x_tc, torch.as_tensor(c["t_taper"]), torch.as_tensor(c["dr"]),
            torch.as_tensor(c["perm"]), n_l, geom.input_keep, kpos, n_blocks,
        ).numpy()
        assert _rel_err(got, ref) < SYNTHESIS_TOL

    @pytest.mark.parametrize("with_elem", [False, True])
    @pytest.mark.parametrize("n_valid", [2, 3])
    def test_epilogue_emulation(self, with_elem, n_valid):
        # the low split (128, 384); n_valid < B leaves the last block alone
        assert plan_ifft(N, LO) == (itf.N2, 384)
        X = _noise((2, 3, N), 12)
        elem = _noise((N,), 13) if with_elem else None
        got, stores = emu_cluster_epilogue(X, elem, N, LO, ROLL, GAIN, n_valid)
        assert (stores == 1).all()  # every kept sample written exactly once
        ref = tsynth.epilogue(torch.as_tensor(X),
                              None if elem is None else torch.as_tensor(elem),
                              LO, ROLL, GAIN, n_valid).numpy()
        assert _rel_err(got, ref) < SYNTHESIS_TOL

    def test_epilogue_emulation_n1_128(self):
        # the other instantiation: n1 = 128, no radix-3 step
        n, lo = 128 * 128, 512
        assert plan_ifft(n, lo) == (128, 128)
        X = _noise((1, 2, n), 42)
        elem = _noise((n,), 43)
        got, stores = emu_cluster_epilogue(X, elem, n, lo, 31, 0.75, 2)
        assert (stores == 1).all()
        ref = tsynth.epilogue(torch.as_tensor(X), torch.as_tensor(elem), lo, 31, 0.75, 2)
        assert _rel_err(got, ref.numpy()) < SYNTHESIS_TOL

    @pytest.mark.parametrize("n_chan,os_f,ov,n1", [
        (128, Rational(4, 3), 48, 192),  # 3 * 64 on a cluster of four
        (256, Rational(8, 7), 32, 448),  # 7 * 64 on a cluster of eight
    ])
    @pytest.mark.parametrize("with_elem", [False, True])
    def test_epilogue_emulation_q64(self, n_chan, os_f, ov, n1, with_elem):
        # the instantiations whose row transform is r1 * 64, at the
        # inversion geometries that reach them (L = 256)
        g = geometry.SynthesisGeometry(n_chan, 256, ov, os_f)
        n, lo = g.output_fft_length, g.output_overlap
        assert plan_ifft(n, lo) == (itf.N2, n1) and itf.PLANS[n1][1] == 64
        X = _noise((1, 2, n), 44)
        elem = _noise((n,), 45) if with_elem else None
        roll, gain = g.fn_width // 2, os_f.de / os_f.nu
        got, stores = emu_cluster_epilogue(X, elem, n, lo, roll, gain, 2)
        assert (stores == 1).all()
        ref = tsynth.epilogue(torch.as_tensor(X),
                              None if elem is None else torch.as_tensor(elem),
                              lo, roll, gain, 2).numpy()
        assert _rel_err(got, ref) < SYNTHESIS_TOL

    @pytest.mark.parametrize("n1", list(itf.PLANS))
    def test_cluster_plan_fits(self, n1):
        # csrc/ifft_fused.cu ClusterPlan: columns, rows of n1 + 1 points and
        # tables of one block of the cluster fit in its shared memory
        r1, q1, cl = itf.PLANS[n1]

        def smem(blocks):
            cpc, rows = n1 // blocks, itf.N2 // blocks
            return 16 + 8 * (itf.N2 * cpc + rows * (n1 + 1) + 126 + (n1 if r1 > 1 else 0)
                             + 24 * cpc + rows + n1)

        assert r1 * q1 == n1 and q1 in (64, 128) and cl in (4, 8)
        assert smem(cl) <= SMEM_LIMIT
        # four blocks would not hold 448: that is why it runs on eight
        assert cl == 4 or smem(4) > SMEM_LIMIT

    def test_cluster_tables_exact(self):
        # the N-level twiddle over every (m1, k2) and the factored roll phase
        # over every kept t, within 2 ulp of the phase of the exact integer
        t = itf.cluster_tables(N, 384, ROLL)
        ulp = float(np.spacing(np.float32(1)))
        k2 = np.arange(128)[:, None]
        got = t["tw_a"][k2 // 16, np.arange(384)[None, :]] * t["tw_b"][k2 % 16,
                                                                     np.arange(384)[None, :]]
        ref = np.exp(2j * np.pi * ((k2 * np.arange(384)[None, :]) % N) / N)
        assert np.abs(got - ref).max() <= 2 * ulp
        tt = np.arange(LO, N - LO)
        got = t["roll_row"][tt % 128] * t["roll_col"][tt // 128]
        assert np.abs(got - np.exp(-2j * np.pi * ((ROLL * tt) % N) / N)).max() <= 2 * ulp
        assert t["tw_pass"].size == 126 and t["tw_a"].shape == (8, 384)
        # emu_8xg is the 128-point backward DFT with outputs d + 8*k
        x = _noise((3, 128), 49)
        y = emu_8xg(x, t["tw_pass"]).reshape(3, 8, 16)
        got = np.empty_like(x)
        got[:, (np.arange(8)[:, None] + 8 * np.arange(16)[None, :]).ravel()] = y.reshape(3, 128)
        assert _rel_err(got, np.fft.ifft(x) * 128) < 2e-6

    # (block, os, n_pol, spectra, extra samples, resident blocks, tiles per
    # run or None for the wrapper's choice). K = apf.K_TILE = 32.
    PADDED_CASES = {
        # 2.3 tiles: the first reads before the stream start, the last is
        # ragged; n_dat odd (the wrapper hands the tensor map a copy with an
        # even polarization stride) and not a multiple of W
        "512-4/3": (512, Rational(4, 3), 2, 73, 11, 3, None),
        "1024-8/7": (1024, Rational(8, 7), 2, 73, 11, 3, None),
        # mid's own geometry (25 phases, S = 7, D = 8: the residue-class
        # fold) at a cut length, odd n_dat
        "mid": (4096, Rational(8, 7), 2, 70, 5, 5, None),
        # one polarization, every tile a run of its own
        "mid-1pol-runs-of-1": (4096, Rational(8, 7), 1, 40, 513, 4, 1),
        # a stream shorter than one tile
        "mid-short": (4096, Rational(8, 7), 2, 9, 100, 7, None),
        # runs of two tiles: the stream ends on a run boundary, whole tiles,
        # n_dat a multiple of W ...
        "runs-end-on-tile": (1024, Rational(8, 7), 2, 128, 0, 2, 2),
        # ... and in the middle of a run's second tile
        "runs-end-ragged": (1024, Rational(8, 7), 2, 101, 7, 2, 2),
        # three polarizations of odd length on two blocks, the longest runs
        "3pol-odd": (512, Rational(4, 3), 3, 150, 1, 2, 16),
    }

    @staticmethod
    def _padded_case(name):
        block, os_f, n_pol, spectra, extra, slots, tiles = TestDecomposition.PADDED_CASES[name]
        step = geometry.analysis_step(block, os_f)
        if block == 4096:  # 25 phases as the mid filter's, any coefficients
            f = np.random.default_rng(4).standard_normal(100353)
        else:
            f = fir.design_pfb_fir_filter(block, os_f, 4)
        f2d_rev = _prep_filter(f, block, reverse=True)
        x = _noise((n_pol, spectra * step + extra), 25)
        return x, f2d_rev, step, slots, tiles

    def _check_padded_emulation(self, name):
        x, f2d_rev, step, slots, tiles = self._padded_case(name)
        got, _ = emu_padded_fold(x, f2d_rev, step, slots, tiles)
        assert not np.isnan(got).any()  # every spectrum's every channel stored
        ref = padded_fold(torch.as_tensor(x), torch.as_tensor(f2d_rev), step).numpy()
        assert _rel_err(got, ref) < PADDED_TOL

    @pytest.mark.parametrize("block,os_f,wds", [(512, Rational(4, 3), (128, 4, 3)),
                                                (1024, Rational(8, 7), (128, 8, 7))])
    def test_padded_fold_emulation(self, block, os_f, wds):
        assert apf.fold_rows(block, geometry.analysis_step(block, os_f)) == wds
        self._check_padded_emulation(f"{block}-{os_f.nu}/{os_f.de}")

    @pytest.mark.parametrize("name", list(PADDED_CASES)[2:])
    def test_padded_fold_emulation_cases(self, name):
        self._check_padded_emulation(name)

    @pytest.mark.parametrize("name", ["512-4/3", "mid", "runs-end-ragged"])
    def test_padded_fold_rows_staged_once(self, name):
        # emu_padded_fold asserts that every box lies in the buffer, that
        # each barrier's expected bytes are its boxes' and that every slot
        # is loaded once per unit before it is read; here the totals: each
        # run stages its window in whole boxes plus one slide per further
        # tile, the first run of each (polarization, column group) gets the
        # D*phases rows before the stream as zeros, and only the boxes that
        # overhang the last whole row read past it
        x, f2d_rev, step, slots, tiles = self._padded_case(name)
        _, counts = emu_padded_fold(x, f2d_rev, step, slots, tiles)
        n_pol, n_dat = x.shape
        phases, block = f2d_rev.shape
        p = apf.plan(block, step, phases)
        nblocks, lanes = n_dat // step, n_pol * (p.w // apf.C_TILE)
        if tiles is None:
            tiles = apf.seg_tiles(p, nblocks, lanes, slots)
        assert counts["before"] == lanes * p.d * phases
        assert counts["advance"] == lanes * p.s * nblocks
        staged, past = 0, 0
        for k_run in range(0, nblocks, tiles * apf.K_TILE):
            n_t = min(tiles, -(-(nblocks - k_run) // apf.K_TILE))
            rows = p.window_pad + p.slide * (n_t - 1)
            staged += rows
            past += max(0, p.s * k_run - p.d * phases + rows - n_dat // p.w)
        assert counts["copied"] + counts["before"] + counts["past"] == lanes * staged
        assert counts["past"] == lanes * past

    def test_padded_fold_mid_smem(self):
        # mid: W = 512, D = 8, S = 7, 25 phases -> a window of 417 rows, 224
        # more per tile in one box, the window in two (448 rows) of 16
        # samples, seven tiles in 227 KB; at the main path's size (1280
        # spectra, 2 x 32 column groups, 132 resident blocks) runs of seven
        # tiles: 384 units in three rounds, the input staged 1792 / 1568 =
        # 1.14 times
        assert apf.fold_rows(4096, 3584) == (512, 8, 7)
        p = apf.plan(4096, 3584, 25)
        assert p == apf.FoldPlan(512, 8, 7, 417, 224, 224, 448, 7)
        assert apf.smem_bytes(4096, 3584, 25) == 128 + 448 * 16 * 8 == 57_472
        assert apf.smem_bytes(4096, 3584, 25, 7) == 128 + 1792 * 128 <= SMEM_LIMIT
        assert apf.smem_bytes(4096, 3584, 25, 8) > SMEM_LIMIT
        assert apf.seg_tiles(p, 1280, 64, 132) == 7
        assert apf.seg_tiles(p, 9, 64, 132) == 1
        assert (25, 7, 8) in apf.SPECIALISED

    @pytest.mark.parametrize("block,step,phases,ok", [
        (4096, 3584, 25, True), (1024, 896, 5, True), (512, 384, 5, True),
        (256, 224, 5, True),     # W = 32: two column groups
        (4096, 3584, 200, False),  # a window of 1817 rows does not fit
        (200, 175, 5, False),    # W = 25
        (384, 336, 5, True),     # W = 48: a multiple of 16, not of 32
    ])
    def test_padded_fold_takes(self, block, step, phases, ok):
        # the predicate, and the raw wrapper raising from it before any
        # launch (meta tensors: no data, no card)
        assert apf.takes(block, step, phases) == ok
        meta = torch.device("meta")
        x = torch.empty((2, 40 * step), dtype=torch.complex64, device=meta)
        f = torch.empty((phases, block), device=meta)
        with pytest.raises(ValueError, match="runs on cuda or cpu" if ok else "the card needs"):
            apf.padded_fold_fused(x, f, step)

    @pytest.mark.parametrize("block", [512, 1024, 3072, 4096])
    @pytest.mark.parametrize("block0,delay", [(0, 0), (5, 3), (3, 40)])
    def test_chan_dft_emulation(self, block, block0, delay):
        step = block * 7 // 8
        const = padded_chan_const(block, step)
        g = _noise((2, 43, block), 26)  # 86 spectra: a ragged last tile below 4096
        got = emu_chan_dft(g, const, block0, delay % 43)
        assert not np.isnan(got).any()  # every output row written once
        ref = chan_dft_core(torch.as_tensor(g), torch.as_tensor(const), block0,
                            delay % 43).numpy()
        assert _rel_err(got, ref) < PADDED_TOL

    @pytest.mark.parametrize("pqn", [(7, 128, 128), (3, 512, 128)])
    @pytest.mark.parametrize("with_elem", [False, True])
    def test_ifft_big_emulation(self, pqn, with_elem):
        p, q, n1 = pqn
        n2 = p * q
        n, lo = n2 * n1, n2 * 8
        X = _noise((1, 3, n), 27)
        elem = _noise((n,), 28) if with_elem else None
        xt = torch.as_tensor(X)
        et = None if elem is None else torch.as_tensor(elem)
        ref = tsynth.epilogue(xt, et, lo, 224, 0.875, 3).numpy()
        a, got = emu_ifft_big(X, elem, n2, n1, lo, 224, 0.875)
        assert _rel_err(got, ref) < BIG_IFFT_TOL
        # A of transform 2, and the outer kernel on it alone
        a_ref = tsynth.big_ifft_inner(xt, et, n2, n1)
        assert _rel_err(a[2], a_ref[0, 2].numpy()) < BIG_IFFT_TOL
        assert _rel_err(emu_big_outer(a[2], n2, n1, lo,
                                      big.big_ifft_tables(n, n2, n1, 224), 0.875 / n),
                        tsynth.big_ifft_outer(a_ref, lo, 224, 0.875)[0, 2].numpy()) < BIG_IFFT_TOL

    def test_ifft_big_emulation_mid(self):
        # one transform of the mid plan (7, 512, 512) at full size, the
        # kernels' tables and index maps against the plain halves
        n2, n1, lo, roll = 3584, 512, 458_752, 224
        n = n2 * n1
        assert plan_big_ifft(n, lo) == (7, 512, 512)
        assert big.kernel_split(n2) == (7, 9) and big.kernel_split(n1, big.OUTER_SPLITS) == (1, 9)
        X = _noise((1, 1, n), 35)
        _, got = emu_ifft_big(X, None, n2, n1, lo, roll, 0.875)
        xt = torch.as_tensor(X)
        a_ref = tsynth.big_ifft_inner(xt, None, n2, n1)
        tables = big.big_ifft_tables(n, n2, n1, roll)
        a = emu_big_inner(X[0, 0], n2, n1, tables)
        assert _rel_err(a, a_ref[0, 0].numpy()) < BIG_IFFT_TOL
        assert _rel_err(got, tsynth.big_ifft_outer(a_ref, lo, roll, 0.875).numpy()) < BIG_IFFT_TOL
        assert _rel_err(got, tsynth.epilogue(xt, None, lo, roll, 0.875, 1).numpy()) < 2e-6

    def test_mid_phase_tables_sweep(self):
        # the two-level N-level twiddle over every (i1, k2) of the mid plan
        # and the factored roll phase over every kept t, against the phase
        # at the exact integer index: within 2 ulp of fp32 (2^-23 at 1)
        n2, n1, lo, roll = 3584, 512, 458_752, 224
        n = n2 * n1
        t = big.big_ifft_tables(n, n2, n1, roll)
        ulp = float(np.spacing(np.float32(1)))
        i1 = np.arange(n1)
        got = t["row_hi"][:, i1 // 32] * t["row_lo"][:, i1 % 32]
        ref = np.exp(2j * np.pi * ((np.arange(n2)[:, None] * i1[None, :]) % n) / n)
        assert np.abs(got - ref).max() <= 2 * ulp
        tt = np.arange(lo, n - lo)
        got = t["roll_row"][tt % n2] * t["roll_col"][tt // n2]
        ref = np.exp(-2j * np.pi * ((roll * tt) % n) / n)
        assert np.abs(got - ref).max() <= 2 * ulp
        assert t["row_hi"].shape == (n2, n1 // 32) and t["row_lo"].shape == (n2, 32)

    @pytest.mark.parametrize("q", [128, 256, 512, 1024, 2048, 4096])
    @pytest.mark.parametrize("r", [1, 3, 7])
    @pytest.mark.parametrize("sign", [-1, 1])
    def test_fft_reg_matches_numpy(self, q, r, sign):
        # the odd pre-step r (ifft_big inner, chan_dft at 3072), then the
        # register passes of Q points: output k = kr + r*kq
        n = r * q
        x = _noise((2, n), q + r)
        tab = twiddle_table(n, sign)
        y = emu_radix_step(x.reshape(2, r, q), tab, q) if r > 1 else x.reshape(2, 1, q)
        z = emu_fft_reg(y, tab, n, sign)  # [row, kr, kq]
        got = z.transpose(0, 2, 1).reshape(2, n)
        ref = np.fft.fft(x) if sign < 0 else np.fft.ifft(x) * n
        assert _rel_err(got, ref) < 2e-6

    @pytest.mark.parametrize("q", [128, 256, 512, 4096])
    def test_pass_twiddles_exact(self, q):
        # every entry the phase of the exact integer j*d, within 1 ulp of fp32
        passes, last = reg_plan(q)
        assert passes == -(-(q.bit_length() - 1) // 3) and last * 8 ** (passes - 1) == q
        tab = pass_twiddles(q, -1)
        ulp = float(np.spacing(np.float32(1)))
        for s in range(passes - 1):
            h = q >> (3 * (s + 1))
            jd = np.arange(1, 8)[:, None] * np.arange(h)[None, :]
            got = tab[q - (q >> (3 * s)):][: 7 * h].reshape(7, h)
            assert np.abs(got - np.exp(-2j * np.pi * jd / (8 * h))).max() <= ulp
        assert tab.size == q - last

    @pytest.mark.parametrize("kernel,n", [("chan_dft", 4096), ("frontend", 128),
                                          ("frontend", 256), ("frontend", 512),
                                          ("analysis", 128), ("analysis", 256),
                                          ("analysis", 512), ("ifft_cluster", 384)])
    def test_swizzle_conflict_free(self, kernel, n):
        # each pass's shared-memory accesses, per half-warp of 16 lanes (the
        # unit of a 64-bit access), fall in 16 distinct eight-byte slots
        logn = n.bit_length() - 1
        lanes = np.arange(16)
        if kernel == "ifft_cluster":
            # columns [m2][n1/4] dense, lanes on neighbouring columns; the
            # exchange: lanes on neighbouring m1 of one row; the rows: lanes
            # on 16 of the 32 rows of n1 + 1 points at one offset
            cpc = n // itf.PLANS[n][2]
            for m2 in range(128):
                assert len(set((m2 * cpc + lanes) % 16)) == 16
            for off in range(0, n - 15, 16):
                assert len(set((off + lanes) % 16)) == 16
            for kl0 in (0, 16):
                for pos in range(n):
                    assert len(set(((kl0 + lanes) * (n + 1) + pos) % 16)) == 16
            return
        passes, last = reg_plan(n)
        span = n // last
        if kernel == "chan_dft":  # the radix-8 passes: lanes on butterflies u
            phys = chan_phys(logn)
            per = n // 8
            groups = [([(u // h) * 8 * h + u % h for u in u0 + lanes], h, 8)
                      for s in range(passes - 1) for h in [n >> (3 * (s + 1))]
                      for u0 in range(0, per, 16)]
        else:  # the radix-8 passes: lanes on rows (channels or spectra) of
            # L + 1 points at one offset
            phys = frontend_phys(logn)
            assert len(set((lanes * (n + 1)) % 16)) == 16
            groups = []
            if kernel == "analysis":  # the fold's stores: lanes on neighbouring j
                groups = [(j0 + lanes, 1, 1) for j0 in range(0, n, 16)]
        for t0 in range(0, span, 16):  # the last pass: lanes on tq, one row
            groups.append((_rev8(t0 + lanes, passes - 1) * last, 1, last))
        for pos, stride, rad in groups:
            for m in range(rad):
                slots = phys[np.asarray(pos) + stride * m] % 16
                assert len(set(slots)) == 16, (kernel, n, stride, m)

    def test_build_log_parse(self):
        # registers and spills per kernel from ptxas -v, by source
        from ska_pst_dsp_tpu_torch.ops.kernels import _build

        log = """// source: chan_dft_fused.cu
ptxas info    : Compiling entry function '_Z15chan_dft_kernelILi1ELi12EEvPK6float2PS0_' for 'sm_90a'
ptxas info    : Function properties for _Z15chan_dft_kernelILi1ELi12EEvPK6float2PS0_
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 420 bytes cmem[0]
// source: synthesis_fused.cu
ptxas info    : Compiling entry function '_Z25synthesis_frontend_kernelILi9EEvPK6float2' for 'sm_90a'
ptxas info    : Function properties for _Z25synthesis_frontend_kernelILi9EEvPK6float2
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 118 registers, used 1 barriers, 444 bytes cmem[0]
// source: inversion_fused.cu
ptxas info    : Compiling entry function '_Z22inversion_fused_kernelI7InvPlanILi216ELi216ELi3ELi64ELb1EEEvPK6float2' for 'sm_90a'
    288 bytes stack frame, 288 bytes spill stores, 296 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 288 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z22inversion_fused_kernelI7InvPlanILi256ELi128ELi3ELi128ELb0EEEvPK6float2' for 'sm_90a'
    168 bytes stack frame, 168 bytes spill stores, 168 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 168 bytes cumulative stack size
"""
        assert _build.parse_ptxas(log) == {
            "chan_dft_fused": {"chan_dft_kernel<1,12>": {
                "registers": 64, "spill_stores": 8, "spill_loads": 12}},
            "synthesis_fused": {"synthesis_frontend_kernel<9>": {
                "registers": 118, "spill_stores": 0, "spill_loads": 0}},
            "inversion_fused": {  # a class template's integers and bool
                "inversion_fused_kernel<216,216,3,64,1>": {
                    "registers": 128, "spill_stores": 288, "spill_loads": 296},
                "inversion_fused_kernel<256,128,3,128,0>": {
                    "registers": 128, "spill_stores": 168, "spill_loads": 168}},
        }

    @pytest.mark.parametrize("case", ["fails", "succeeds", "meta"])
    def test_launch(self, case, monkeypatch):
        # the one launch path, on a fake library: a non-zero status raises
        # naming the wrapper and counts nothing, a zero one counts one
        # launch, and a tensor on neither the card nor the CPU raises the one
        # device error before the library is asked
        import contextlib
        import types

        from ska_pst_dsp_tpu_torch.ops import kernels

        calls = []
        status = 2 if case == "fails" else 0
        lib = types.SimpleNamespace(fake_launch=lambda *a: calls.append(a) or status)
        monkeypatch.setattr(kernels._build, "library", lambda: lib)
        monkeypatch.setattr(kernels, "stream_of", lambda t: 99)
        monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())

        def fake():
            pass

        fake.launches = 5
        card = types.SimpleNamespace(device=torch.device("cuda", 0))
        if case == "meta":
            with pytest.raises(ValueError, match="fake runs on cuda or cpu, not meta"):
                kernels.launch(fake, "fake_launch", torch.empty(1, device="meta"), 1, 2)
            assert calls == [] and fake.launches == 5
        elif case == "fails":
            with pytest.raises(RuntimeError, match="fake: CUDA launch failed, cudaError_t 2"):
                kernels.launch(fake, "fake_launch", card, 1, 2)
            assert calls == [(1, 2, 99)] and fake.launches == 5
        else:
            kernels.launch(fake, "fake_launch", card, 1, 2)
            assert calls == [(1, 2, 99)] and fake.launches == 6

    @pytest.mark.parametrize("key", [
        "analysis_fused", "synthesis_fused", "ifft_fused", "analysis_padded_fused",
        "chan_dft_fused", "ifft_big_inner", "ifft_big_outer", "dada_unpack",
        "lowcbf_unpack", "dada_pack", "inversion_fused"])
    def test_wrapper_registered(self, key):
        # the eleven keys, each wrapper with its counter and its span (a call
        # without operands raises inside the span)
        ws = wrappers()
        assert len(ws) == 11 and isinstance(ws[key].launches, int)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with pytest.raises(TypeError):
                ws[key](torch.empty(0, device="meta"))
        assert [e.name for e in prof.events() if e.name.startswith("pst:")] == [
            f"pst:kernel.{key}"]

    def test_wrappers_refuse_lengths(self):
        # a length the kernels are not instantiated for raises before any
        # launch (meta tensors: no data, no card)
        meta = torch.device("meta")
        for block in (256, 640, 6144, 8192):
            g = torch.empty((2, 5, block), dtype=torch.complex64, device=meta)
            with pytest.raises(ValueError, match="takes blocks"):
                chan_dft_ramp(g, torch.empty((8, block), dtype=torch.complex64, device=meta))
        g = torch.empty((2, 5, 4096), dtype=torch.complex64, device=meta)
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            chan_dft_ramp(g, torch.empty((8, 4096), dtype=torch.complex64, device=meta))
        flat = torch.empty((1, 2, 458_752), dtype=torch.complex64, device=meta)
        with pytest.raises(ValueError, match="fused_big_ifft_oc runs on cuda or cpu, not meta"):
            fused_big_ifft_oc(flat, shape_key=(458_752, 1, 896, 512, 114_688, 0, 1.0))
        x = torch.empty((2, 4000, 64), dtype=torch.complex64, device=meta)
        for n_l in (64, 384, 1024):
            with pytest.raises(ValueError, match="takes L in"):
                synthesis_fused(x, torch.empty(n_l), torch.empty(n_l // 2),
                                torch.empty(64, dtype=torch.int32), n_l, n_l // 2, 0, 3)
        for block in (64, 640, 2048):
            with pytest.raises(ValueError, match="takes blocks"):
                analysis_fused(torch.empty((2, 9000), dtype=torch.complex64, device=meta),
                               torch.empty((4, block), device=meta),
                               torch.empty((4, block), dtype=torch.complex64, device=meta), 192)
        flat = torch.empty((2, 3, 256 * 192), dtype=torch.complex64, device=meta)
        with pytest.raises(ValueError, match="cluster epilogue takes"):
            fused_big_ifft(flat, shape_key=(256 * 192, 256, 192, 0, 0, 1.0))
        assert af.BLOCKS == (128, 256, 384, 512, 768, 1024)
        assert itf.N1S == (128, 192, 384, 448)
        assert sorted(cdf.BLOCKS) == [512, 1024, 2048, 3072, 4096]
        assert sorted(tsf.LENGTHS) == [128, 256, 512]

    def test_kernel_split(self):
        assert big.kernel_split(3584) == (7, 9) and big.kernel_split(896) == (7, 7)
        assert big.kernel_split(2048) == (4, 9) and big.kernel_split(384, big.OUTER_SPLITS) == (3, 7)
        with pytest.raises(ValueError, match="out-of-core kernels"):
            big.kernel_split(5 * 512)

    def test_fused_big_ifft_oc_checks(self):
        # an (re, im) pair comes back as a pair equal to the complex path; a
        # key whose factors miss n and a keep region that is not whole n2
        # rows are refused
        n2, n1, lo = 896, 128, 896 * 8
        n = n2 * n1
        key = (n, 7, 128, n1, lo, 224, 0.875)
        X = torch.as_tensor(_noise((1, 2, n), 38))
        re, im = big.fused_big_ifft_oc((X.real.contiguous(), X.imag.contiguous()),
                                       shape_key=key)
        ref = big.fused_big_ifft_oc(X, shape_key=key)
        assert torch.equal(torch.complex(re, im), ref)
        with pytest.raises(ValueError, match="n = p\\*q\\*n1"):
            big.fused_big_ifft_oc(X, shape_key=(n, 7, 128, 256, lo, 224, 0.875))
        with pytest.raises(ValueError, match="whole n2"):
            big._keep_rows(n, n2, lo + 1)

    def test_big_ifft_halves_compose_to_epilogue(self):
        # the two plain halves at the kernels' boundary equal the epilogue
        n2, n1, lo = 896, 512, 114_688  # a reduced mid block: 458752 points
        X = torch.as_tensor(_noise((2, 1, n2 * n1), 29))
        elem = torch.as_tensor(_noise((n2 * n1,), 30))
        got = tsynth.big_ifft_outer(tsynth.big_ifft_inner(X, elem, n2, n1), lo, 224, 0.875)
        ref = tsynth.epilogue(X, elem, lo, 224, 0.875, 1)
        assert _rel_err(got.numpy(), ref.numpy()) < 2e-6


class TestPlainVsPallas:
    def test_analysis_time_major_keep_padding(self, filt, pallas):
        jax_analysis_fused = pallas[0].polyphase_analysis_fused
        x = _noise((2, 60_000), 14)
        pair = (np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))
        (jr, ji), jnb = jax_analysis_fused(pair, filt, N_CHAN, OS, time_major=True,
                                           keep_padding=True, interpret=True)
        (gr, gi), nb = polyphase_analysis_fused(
            (torch.as_tensor(pair[0]), torch.as_tensor(pair[1])), filt, N_CHAN, OS,
            time_major=True, keep_padding=True,
        )
        assert nb == jnb and gr.shape == (2, nb, N_CHAN)
        ref = np.asarray(jr)[:, :nb] + 1j * np.asarray(ji)[:, :nb]
        assert _rel_err(gr.numpy() + 1j * gi.numpy(), ref) < ANALYSIS_TOL

    def test_analysis_channel_major_complex(self, filt, pallas):
        jax_analysis_fused = pallas[0].polyphase_analysis_fused
        x = _noise((1, 1, 30_000), 15)
        got = polyphase_analysis_fused(x, filt, N_CHAN, OS).numpy()
        ref = np.asarray(jax_analysis_fused(x, filt, N_CHAN, OS, interpret=True))
        assert _rel_err(got, ref) < ANALYSIS_TOL
        with pytest.raises(ValueError, match="keep_padding"):
            polyphase_analysis_fused(x, filt, N_CHAN, OS, keep_padding=True)

    def test_synthesis_time_major_valid_len(self, filt, pallas):
        jax_synthesis_fused = pallas[1].polyphase_synthesis_fused
        # a tail-padded time-major stream: only the first valid_len rows count
        x = _noise((2, 1200 + 40, N_CHAN), 16)
        pair = (np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))
        kw = dict(input_overlap=OV, deripple_coeff=filt, temporal_taper="tukey",
                  time_major_in=True, valid_len=1200)
        jr, ji = jax_synthesis_fused(pair, L, OS, interpret=True, **kw)
        gr, gi = polyphase_synthesis_fused(
            (torch.as_tensor(pair[0]), torch.as_tensor(pair[1])), L, OS, **kw
        )
        assert _rel_err(gr.numpy() + 1j * gi.numpy(),
                        np.asarray(jr) + 1j * np.asarray(ji)) < SYNTHESIS_TOL

    def test_synthesis_channel_major_combine(self, filt, pallas):
        jax_synthesis_fused = pallas[1].polyphase_synthesis_fused
        x = _noise((1, N_CHAN, 1200), 17)
        kw = dict(input_overlap=OV, deripple_coeff=filt, temporal_taper="tukey",
                  combine=16, spectral_taper="tukey")
        ref = np.asarray(jax_synthesis_fused(x, L, OS, interpret=True, **kw))
        got = polyphase_synthesis_fused(x, L, OS, **kw).numpy()
        assert _rel_err(got, ref) < SYNTHESIS_TOL

    @pytest.mark.parametrize("block", [1024, 4096])
    @pytest.mark.parametrize("block0,delay", [(0, 0), (3, 5)])
    def test_chan_dft_emulation_vs_pallas(self, block, block0, delay):
        # the Pallas channel DFT (tiles of KB spectra, the constant tiled to
        # KB rows, no roll) in interpret mode against the emulated kernel
        from ska_pst_dsp_tpu.ops.pallas.chan_dft_fused import KB
        from ska_pst_dsp_tpu.ops.pallas.chan_dft_fused import chan_dft_ramp as jax_chan_dft

        const = padded_chan_const(block, block * 7 // 8)
        nu = const.shape[0]
        g = _noise((2, 9, block), 39)
        ct = const[(np.arange(KB) + block0) % nu]
        jr, ji = jax_chan_dft(np.ascontiguousarray(g.real), np.ascontiguousarray(g.imag),
                              np.ascontiguousarray(ct.real), np.ascontiguousarray(ct.imag),
                              block=block, interpret=True)
        ref = np.roll(np.asarray(jr) + 1j * np.asarray(ji), -delay, axis=1)
        assert _rel_err(emu_chan_dft(g, const, block0, delay), ref) < PADDED_TOL

    @pytest.mark.parametrize("n_l,combine,time_major", [(256, 1, True), (256, 16, False),
                                                        (512, 1, False), (512, 16, True)])
    def test_frontend_emulation_vs_pallas(self, n_l, combine, time_major, pallas):
        # the emulated frontend kernel, then the plain epilogue, against the
        # Pallas frontend + epilogue in interpret mode (32 channels)
        jax_synthesis_fused = pallas[1].polyphase_synthesis_fused
        n_chan = 32
        os_f, ov = (OS, OV) if n_l == 256 else (Rational(8, 7), 128)
        f = fir.design_pfb_fir_filter(n_chan, os_f, 12)
        geom = geometry.SynthesisGeometry(n_chan, n_l, ov, os_f)
        n_dat = 2 * ov + 2 * geom.input_keep + 40
        kw = dict(input_overlap=ov, deripple_coeff=f, temporal_taper="tukey",
                  combine=combine)
        c = tsynth.synthesis_constants(n_chan, n_l, os_f, ov, deripple_coeff=f,
                                       temporal_taper="tukey", combine=combine)
        if time_major:
            x = _noise((1, n_dat, n_chan), 40)
            strides = (n_dat * n_chan, n_chan, 1)
            pair = (np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))
            jr, ji = jax_synthesis_fused(pair, n_l, os_f, interpret=True,
                                         time_major_in=True, **kw)
            ref = np.asarray(jr) + 1j * np.asarray(ji)
        else:
            x = _noise((1, n_chan, n_dat), 40)
            strides = (n_chan * n_dat, 1, n_dat)
            ref = np.asarray(jax_synthesis_fused(x, n_l, os_f, interpret=True, **kw))
        nb = geom.n_blocks(n_dat)
        fn = emu_frontend(x.ravel(), strides, (1, n_dat, n_chan), c["t_taper"], c["dr"],
                          c["perm"], geom.input_keep, (n_l // 2 + geom.discard) % n_l, nb)
        got = tsynth.epilogue(torch.as_tensor(fn.reshape(1, nb, -1)), None,
                              geom.output_overlap, geom.fn_width // 2,
                              os_f.de / os_f.nu, nb).reshape(1, 1, -1).numpy()
        assert _rel_err(got, ref) < SYNTHESIS_TOL

    @pytest.mark.parametrize("block,os_f", [(256, OS), (512, Rational(8, 7)), (384, OS)])
    def test_analysis_emulation_vs_pallas(self, filt, block, os_f, pallas):
        # the emulated kernel against the Pallas kernel in interpret mode
        step = geometry.analysis_step(block, os_f)
        f = filt if block == N_CHAN else fir.design_pfb_fir_filter(block, os_f, 4)
        f2d = _prep_filter(f, block)
        n_dat = f2d.shape[0] * block + step * 40 + 5
        x = _noise((2, n_dat), 44)
        ref = np.asarray(pallas[0].polyphase_analysis_fused(x[:, None, :], f, block, os_f,
                                                            interpret=True))
        got = emu_analysis(x, f2d, ramp_table(block, step), step, 0)
        assert _rel_err(got.transpose(0, 2, 1), ref) < ANALYSIS_TOL

    @pytest.mark.parametrize("with_elem", [False, True])
    def test_epilogue_emulation_vs_pallas(self, with_elem, pallas):
        # the emulated cluster kernel against the Pallas epilogue in
        # interpret mode, n_valid = 2 of 3 blocks
        import jax.numpy as jnp

        key = (N, *plan_ifft(N, LO), LO, ROLL, GAIN)
        X = _noise((2, 3, N), 45)
        elem = _noise((N,), 46)
        jr, ji = pallas[2].fused_big_ifft(
            jnp.asarray(np.ascontiguousarray(X.real)), jnp.asarray(np.ascontiguousarray(X.imag)),
            *((jnp.asarray(elem.real.copy()), jnp.asarray(elem.imag.copy())) if with_elem
              else (None, None)),
            shape_key=key, has_elem=with_elem, n_valid=2, interpret=True,
        )
        got, _ = emu_cluster_epilogue(X, elem if with_elem else None, N, LO, ROLL, GAIN, 2)
        assert _rel_err(got, np.asarray(jr) + 1j * np.asarray(ji)) < SYNTHESIS_TOL

    @pytest.mark.parametrize("with_elem", [False, True])
    def test_fused_big_ifft(self, with_elem, pallas):
        import jax.numpy as jnp

        jax_fused_big_ifft = pallas[2].fused_big_ifft
        plan = plan_ifft(N, LO)
        assert plan == pallas[2].plan_ifft(N, LO) == (128, 384)
        rng = np.random.default_rng(18)
        fr, fi = (rng.standard_normal((2, 3, N)).astype(np.float32) for _ in range(2))
        er, ei = (rng.standard_normal(N).astype(np.float32) for _ in range(2))
        key = (N, *plan, LO, ROLL, GAIN)
        jr, ji = jax_fused_big_ifft(
            jnp.asarray(fr), jnp.asarray(fi),
            *((jnp.asarray(er), jnp.asarray(ei)) if with_elem else (None, None)),
            shape_key=key, has_elem=with_elem, n_valid=2, interpret=True,
        )
        gr, gi = fused_big_ifft(
            (torch.as_tensor(fr), torch.as_tensor(fi)),
            (torch.as_tensor(er), torch.as_tensor(ei)) if with_elem else None,
            shape_key=key, n_valid=2,
        )
        assert _rel_err(gr.numpy() + 1j * gi.numpy(),
                        np.asarray(jr) + 1j * np.asarray(ji)) < SYNTHESIS_TOL

    @pytest.mark.parametrize("n,lo", [(49152, 9216), (1_835_008, 458_752),
                                      (12288, 1536), (3 * 7 * 512, 0)])
    def test_epilogue_dispatch_matches_jax(self, n, lo, pallas):
        assert plan_ifft(n, lo) == pallas[2].plan_ifft(n, lo)
        assert plan_big_ifft(n, lo) == pallas[3].plan_big_ifft(n, lo)

    @pytest.mark.parametrize("n,lo", [(7 * 128 * 128, 7168), (3 * 512 * 128, 12288),
                                      (458_752, 114_688), (1_835_008, 458_751),
                                      (1_835_008, 917_504), (5 * 7 * 512, 0),
                                      (2 ** 20, 2 ** 18), (6 * 512 * 512, 3 * 2 ** 17)])
    def test_plan_big_ifft_sweep(self, n, lo, pallas):
        assert plan_big_ifft(n, lo) == pallas[3].plan_big_ifft(n, lo)

    @pytest.mark.parametrize("pqn", [(7, 128, 128), (3, 512, 128)])
    @pytest.mark.parametrize("with_elem", [False, True])
    def test_fused_big_ifft_oc(self, pqn, with_elem, pallas):
        # the plain epilogue reached through the out-of-core wrapper, against
        # the Pallas pair in interpret mode at test_pallas.py's shapes
        import jax.numpy as jnp

        p, q, n1 = pqn
        n, n2 = p * q * n1, p * q
        key = (n, p, q, n1, n2 * 8, 224, 0.875)
        rng = np.random.default_rng(24)
        fr, fi = (rng.standard_normal((1, 2, n)).astype(np.float32) for _ in range(2))
        er, ei = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
        jr, ji = pallas[3].fused_big_ifft_oc(
            jnp.asarray(fr), jnp.asarray(fi),
            *((jnp.asarray(er), jnp.asarray(ei)) if with_elem else (None, None)),
            shape_key=key, has_elem=with_elem, interpret=True,
        )
        gr, gi = fused_big_ifft_oc(
            (torch.as_tensor(fr), torch.as_tensor(fi)),
            (torch.as_tensor(er), torch.as_tensor(ei)) if with_elem else None,
            shape_key=key,
        )
        assert _rel_err(gr.numpy() + 1j * gi.numpy(),
                        np.asarray(jr) + 1j * np.asarray(ji)) < BIG_IFFT_TOL


#: geometries the JAX package's fused path computes beside the two main
#: paths' (channels, OS, L, overlap, the split plan_ifft gives, and the
#: epilogue kernel that split goes to on the card; the pair runs on
#: tsf.epilogue_plan's split of the same length: the plan's own where it
#: has kernels for it, else 896 * 128 for the 114688 points of SKA-Mid's
#: 256-channel groups, whose (256, 448) neither kernel takes)
EXTRA = {
    "512ch-4/3": (512, Rational(4, 3), 256, 48, (256, 384), "pair"),
    "128ch-4/3": (128, Rational(4, 3), 256, 48, (128, 192), "cluster"),
    "256ch-8/7": (256, Rational(8, 7), 256, 32, (128, 448), "cluster"),
    "256ch-8/7-L512": (256, Rational(8, 7), 512, 128, (256, 448), "pair"),
}


#: (n, lo) of an inversion block and its epilogue's (route, n2, n1), frozen
#: from the route the port chose before the choice was one cached plan:
#: each configuration of config/test.config.json with an integral inversion
#: (sps has none), EXTRA's, the cascades' slabs, SKA-Mid reduced to 1024
#: channels, a plan_ifft split no kernel takes and an n1 = 128 split
ROUTES = {
    "low": ((49152, 9216), ("cluster", 128, 384)),
    "low_alt": ((49152, 9216), ("cluster", 128, 384)),
    "lowpsi": ((49152, 9216), ("cluster", 128, 384)),
    "lowpsi_old": ((49152, 9216), ("cluster", 128, 384)),
    "low_external": ((49152, 9216), ("cluster", 128, 384)),
    "mid": ((1835008, 458752), ("pair", 3584, 512)),
    "mid_external": ((917504, 114688), ("pair", 1792, 512)),
    "test32": ((1536, 384), ("composed", None, None)),
    "512ch-4/3": ((98304, 18432), ("pair", 256, 384)),
    "128ch-4/3": ((24576, 4608), ("cluster", 128, 192)),
    "256ch-8/7": ((57344, 7168), ("cluster", 128, 448)),
    "256ch-8/7-L512": ((114688, 28672), ("pair", 896, 128)),
    "216ch-slab": ((41472, 7776), ("composed", None, None)),
    "192ch-critical": ((36864, 6912), ("composed", None, None)),
    "3072ch-combine16": ((589824, 110592), ("pair", 1536, 384)),
    "1024ch-8/7-L512": ((458752, 114688), ("pair", 896, 512)),
    "256ch-4/3-L384": ((73728, 9216), ("cluster", 256, 288)),
    "n1-128": ((16384, 512), ("cluster", 128, 128)),
}


class TestDropIns:
    """The public fused functions take on the card every geometry the JAX
    package's fused path takes, on a hand-written kernel; what no kernel is
    instantiated for they refuse there (ValueError before any launch) and
    run as the plain version on the CPU only."""

    @pytest.mark.parametrize("name", ["low", "low_alt", "sps", "low_external", "mid",
                                      "mid_external"])
    def test_configurations_are_taken(self, name):
        # every configuration of config/test.config.json on a fused path:
        # each kernel its geometry reaches has an instantiation
        from ska_pst_dsp_tpu_torch.utils.config import load_config

        cfg = load_config(name)
        block, os_f = cfg.channels, Rational(cfg.os_factor.nu, cfg.os_factor.de)
        step = geometry.analysis_step(block, os_f)
        phases = geometry.padded_filter_length(cfg.fir_filter_taps, block) // block
        if cfg.analysis_function == "polyphase_analysis_padded":
            assert apf.takes(block, step, phases) and cdf.takes(block)
        else:
            assert af.takes(block, step, phases, block // math.gcd(step, block))
        if name == "sps":  # stage one of a cascade: its own inversion is not integral
            return
        assert tsf.takes(cfg.input_fft_length)
        g = geometry.SynthesisGeometry(block, cfg.input_fft_length, cfg.input_overlap, os_f)
        small = plan_ifft(g.output_fft_length, g.output_overlap)
        large = plan_big_ifft(g.output_fft_length, g.output_overlap)
        expect = {"mid": (None, (7, 512, 512)),
                  "mid_external": (None, (7, 256, 512))}.get(name, ((128, 384), None))
        assert (small, large) == expect
        assert small is None or itf.takes(*small)
        assert large is None or big.takes(large[0] * large[1], large[2])

    @pytest.mark.parametrize("name", list(EXTRA))
    def test_extra_geometries_are_taken(self, name):
        # the analysis and the frontend have kernels for them; the epilogue's
        # split goes to the cluster kernel, or, where a block does not fit in
        # a cluster's shared memory, to the out-of-core pair
        n_chan, os_f, n_l, ov, split, kernel = EXTRA[name]
        g = geometry.SynthesisGeometry(n_chan, n_l, ov, os_f)
        n, lo = g.output_fft_length, g.output_overlap
        step = geometry.analysis_step(n_chan, os_f)
        assert af.takes(n_chan, step, 5, n_chan // math.gcd(step, n_chan)) and tsf.takes(n_l)
        assert plan_ifft(n, lo) == split and plan_big_ifft(n, lo) is None
        route, n2, n1 = tsf.epilogue_plan(n, lo)
        assert route == kernel and {"cluster": itf, "pair": big}[route].takes(n2, n1)
        if kernel == "pair":  # the raw cluster wrapper refuses it from the same predicate
            flat = torch.empty((1, 2, n), dtype=torch.complex64, device="meta")
            with pytest.raises(ValueError, match="cluster epilogue takes"):
                fused_big_ifft(flat, shape_key=(n, *split, lo, 0, 1.0))

    @pytest.mark.parametrize("name", list(ROUTES))
    def test_epilogue_plan_frozen(self, name):
        # the cached plan gives the frozen route and split; a configuration's
        # row is its own geometry's
        from ska_pst_dsp_tpu_torch.utils.config import load_config

        (n, lo), route = ROUTES[name]
        if name in ("low", "low_alt", "lowpsi", "lowpsi_old", "low_external", "mid",
                    "mid_external", "test32"):
            cfg = load_config(name)
            g = geometry.SynthesisGeometry(cfg.channels, cfg.input_fft_length,
                                           cfg.input_overlap,
                                           Rational(cfg.os_factor.nu, cfg.os_factor.de))
            assert (g.output_fft_length, g.output_overlap) == (n, lo)
        assert tsf.epilogue_plan(n, lo) == route
        hits = tsf.epilogue_plan.cache_info().hits
        assert tsf.epilogue_plan(n, lo) == route  # decided once: the second call is a hit
        assert tsf.epilogue_plan.cache_info().hits == hits + 1

    @pytest.mark.parametrize("name", list(EXTRA))
    def test_extra_epilogue_dispatch(self, name, monkeypatch):
        # fused_inversion hands each split to the wrapper of the kernel that
        # takes it, with that wrapper's key
        n_chan, os_f, n_l, ov, split, kernel = EXTRA[name]
        g = geometry.SynthesisGeometry(n_chan, n_l, ov, os_f)
        n, lo = g.output_fft_length, g.output_overlap
        calls = []

        def record(which, wrapped):
            def fn(flat, elem=None, **kw):
                calls.append((which, kw["shape_key"][:-3]))
                return wrapped(flat, elem, **kw)
            return fn

        monkeypatch.setattr(tsf, "fused_big_ifft", record("cluster", fused_big_ifft))
        monkeypatch.setattr(tsf, "fused_big_ifft_oc", record("pair", fused_big_ifft_oc))
        x = _noise((1, n_chan, 2 * ov + g.input_keep), 55)
        got = polyphase_synthesis_fused(x, n_l, os_f, input_overlap=ov)
        n2, n1 = tsf.epilogue_plan(n, lo)[1:]
        key = (n, *split) if kernel == "cluster" else (n, 1, n2, n1)
        assert calls == [(kernel, key)]
        ref = tsynth.polyphase_synthesis(torch.as_tensor(x), n_l, os_f, input_overlap=ov)
        assert torch.equal(got, ref)

    @pytest.mark.parametrize("name", list(EXTRA))
    def test_extra_analysis_matches_jax(self, name, pallas):
        n_chan, os_f = EXTRA[name][:2]
        f = fir.design_pfb_fir_filter(n_chan, os_f, 4)
        step = geometry.analysis_step(n_chan, os_f)
        x = _noise((1, 1, f.size + 40 * step + 5), 50)
        got = polyphase_analysis_fused(x, f, n_chan, os_f).numpy()
        ref = np.asarray(pallas[0].polyphase_analysis_fused(x, f, n_chan, os_f,
                                                            interpret=True))
        assert _rel_err(got, ref) < ANALYSIS_TOL

    @pytest.mark.parametrize("name", list(EXTRA))
    def test_extra_synthesis_matches_jax(self, name, pallas):
        n_chan, os_f, n_l, ov = EXTRA[name][:4]
        f = fir.design_pfb_fir_filter(n_chan, os_f, 4)
        g = geometry.SynthesisGeometry(n_chan, n_l, ov, os_f)
        x = _noise((1, n_chan, 2 * ov + 2 * g.input_keep), 51)
        kw = dict(input_overlap=ov, deripple_coeff=f, temporal_taper="tukey")
        got = polyphase_synthesis_fused(x, n_l, os_f, **kw).numpy()
        ref = np.asarray(pallas[1].polyphase_synthesis_fused(x, n_l, os_f, interpret=True,
                                                             **kw))
        assert _rel_err(got, ref) < SYNTHESIS_TOL

    def test_mid_group_split(self):
        # 114688 = 256 * 448 points, overlap 28672: neither kernel takes the
        # plan's split, the pair takes 896 = 7 * 128 inner by 128 outer
        g = geometry.SynthesisGeometry(256, 512, 128, Rational(8, 7))
        n, lo = g.output_fft_length, g.output_overlap
        assert (n, lo) == (114688, 28672) and plan_ifft(n, lo) == (256, 448)
        assert not itf.takes(256, 448) and not big.takes(256, 448)
        assert tsf.epilogue_plan(n, lo) == ("pair", 896, 128) and big.takes(896, 128)

    def test_mid_group_elem_matches_jax(self, pallas):
        # the chirp as the spectral filter of a band-limited group inversion
        # (spans_nyquist False), against the JAX fused path in interpret mode
        from ska_pst_dsp_tpu.ops import dedispersion as jax_dedisp
        from ska_pst_dsp_tpu_torch.ops import dedispersion

        n_chan, os_f, n_l, ov = EXTRA["256ch-8/7-L512"][:4]
        f = fir.design_pfb_fir_filter(n_chan, os_f, 4)
        g = geometry.SynthesisGeometry(n_chan, n_l, ov, os_f)
        args = (n_chan * g.fn_width, 1.0, 1406.25, 2.5)
        x = _noise((1, n_chan, 2 * ov + 2 * g.input_keep), 57)
        kw = dict(input_overlap=ov, deripple_coeff=f, temporal_taper="tukey",
                  spans_nyquist=False)
        got = polyphase_synthesis_fused(
            x, n_l, os_f, spectral_filter=dedispersion.chirp_filter(*args), **kw).numpy()
        ref = np.asarray(pallas[1].polyphase_synthesis_fused(
            x, n_l, os_f, spectral_filter=jax_dedisp.chirp_filter(*args), interpret=True,
            **kw))
        assert _rel_err(got, ref) < SYNTHESIS_TOL

    @pytest.mark.parametrize("block,os_f", [(2048, Rational(4, 3)),  # W = 512, S = 3
                                            (640, Rational(4, 3))])
    def test_analysis_not_taken(self, block, os_f):
        # a block the analysis kernel is not instantiated for: the plain
        # version on the CPU, ValueError off it (a meta tensor: no data, no card)
        f = fir.design_pfb_fir_filter(block, os_f, 4)
        step = geometry.analysis_step(block, os_f)
        x = _noise((1, f.size + 9 * step), 52)
        assert not af.takes(block, step, 5, block // math.gcd(step, block))
        got = polyphase_analysis_fused(x, f, block, os_f, block0=2, time_major=True)
        ref = analysis_core(torch.as_tensor(x), torch.as_tensor(_prep_filter(f, block)),
                            torch.as_tensor(ramp_table(block, step)), step, 2)
        assert torch.equal(got, ref)
        before = analysis_fused.launches
        with pytest.raises(ValueError, match="takes blocks"):
            polyphase_analysis_fused(torch.as_tensor(x, device="meta"), f, block, os_f)
        assert analysis_fused.launches == before

    @pytest.mark.parametrize("block,os_f,match", [
        (256, Rational(8, 7), "chan_dft_ramp takes blocks"),  # the fold takes W = 32
        (200, Rational(8, 7), "chan_dft_ramp takes blocks"),  # W = 25: neither kernel
        (1024, Rational(8, 7), None),                         # both kernels take it
    ])
    @pytest.mark.parametrize("time_major", [False, True])
    def test_padded_not_taken(self, block, os_f, match, time_major):
        from ska_pst_dsp_tpu.ops import polyphase_analysis_padded as jax_padded

        f = fir.design_pfb_fir_filter(block, os_f, 4)
        x = _noise((2, 30 * block), 53)
        got = apf.polyphase_analysis_padded_fused(x, f, block, os_f, block0=3,
                                                  time_major=time_major).numpy()
        ref = np.asarray(jax_padded(x, f, block, os_f, block0=3))
        assert _rel_err(got.transpose(0, 2, 1) if time_major else got, ref) < PADDED_TOL
        step = geometry.analysis_step(block, os_f)
        assert (apf.takes(block, step, 5) and cdf.takes(block)) == (match is None)
        if match is not None:
            before = (apf.padded_fold_fused.launches, chan_dft_ramp.launches)
            with pytest.raises(ValueError, match=match):
                apf.polyphase_analysis_padded_fused(torch.as_tensor(x, device="meta"), f,
                                                    block, os_f)
            assert (apf.padded_fold_fused.launches, chan_dft_ramp.launches) == before

    def test_padded_fold_not_taken(self):
        # W = 25 is no multiple of the kernel's 16 columns: the raw fold
        # wrapper raises from the predicate
        f2d_rev = torch.empty((5, 200), device="meta")
        assert not apf.takes(200, 175, 5)
        with pytest.raises(ValueError, match="padded fold of 5 phases x 200"):
            apf.padded_fold_fused(torch.empty((2, 6000), dtype=torch.complex64,
                                              device="meta"), f2d_rev, 175)

    def test_frontend_not_taken(self, filt):
        # L = 384 has no frontend kernel: the plain inversion on the CPU,
        # ValueError off it before anything is launched
        n_l, ov = 384, 48
        assert not tsf.takes(n_l) and plan_ifft(256 * 288, 48 * 192) == (256, 288)
        assert not itf.takes(256, 288) and not big.takes(256, 288)
        x = _noise((1, N_CHAN, 2 * ov + 2 * (n_l - 2 * ov)), 54)
        kw = dict(input_overlap=ov, deripple_coeff=filt, temporal_taper="tukey")
        got = polyphase_synthesis_fused(x, n_l, OS, **kw)
        ref = tsynth.polyphase_synthesis(torch.as_tensor(x), n_l, OS, **kw)
        assert torch.equal(got, ref)
        before = synthesis_fused.launches
        with pytest.raises(ValueError, match="takes L in"):
            polyphase_synthesis_fused(torch.as_tensor(x, device="meta"), n_l, OS, **kw)
        assert synthesis_fused.launches == before


def _low_inversion_args(n_chan=N_CHAN, n_l=L, ov=OV, os_f=OS, elem_seed=None, **kw):
    """(constants, keep, kpos, lo, roll, gain, elem) of an inversion
    geometry (``kw`` to synthesis_constants), elem a random (N,) factor or
    None."""
    g = geometry.SynthesisGeometry(n_chan, n_l, ov, os_f)
    c = tsynth.synthesis_constants(n_chan, n_l, os_f, ov, temporal_taper="tukey", **kw)
    c["dr"] = np.linspace(0.5, 1.5, g.fn_width).astype(np.float32)
    elem = None if elem_seed is None else _noise((g.output_fft_length,), elem_seed)
    return (g, [torch.as_tensor(c[k]) for k in ("t_taper", "dr", "perm")], g.input_keep,
            (n_l // 2 + g.discard) % n_l, g.output_overlap, g.fn_width // 2,
            os_f.de / os_f.nu, elem)


#: the fused inversion's two geometries: SKA-Low, and a LowCBF PST slab (the
#: cascade's 216 kept channels a coarse channel, in monotonic order); and the
#: slab of a PST node that dedisperses, whose discard is the taper's 48 and
#: the chirp's reach, 64 a side
FUSED_GEOMS = {"low": (N_CHAN, {}), "slab216": (216, {"monotonic": True}),
               "node216": (216, {"monotonic": True, "ov": 64, "taper_overlap": OV})}


#: the seams test_kernel_emulation_seam puts between a stream's held samples
#: and its new block (h by the hop), and the sides of the five frames at
#: that h (0 held, 1 the new block, 2 across): none; inside the first
#: frame; on a hop boundary, frame 2's start; past two whole frames
SEAMS = {"none": lambda keep: 0, "first_frame": lambda keep: 100,
         "hop": lambda keep: 2 * keep, "past_frames": lambda keep: 3 * keep + 37}
SEAM_SIDES = {"none": [1] * 5, "first_frame": [2, 1, 1, 1, 1], "hop": [0, 2, 1, 1, 1],
              "past_frames": [0, 0, 2, 2, 1]}


def _strided_input(n_pol, n, n_chan, layout, seed, off=3):
    """A (n_pol, n, n_chan) complex64 input ``off`` elements into a flat
    buffer, time-major or channel-major: (emu_frame_load's (flat buffer,
    shape, element strides), the same as a torch view)."""
    strides = (n * n_chan, n_chan, 1) if layout == "time_major" else (n * n_chan, 1, n)
    flat = _noise((off + n_pol * n * n_chan,), seed)
    view = torch.as_strided(torch.as_tensor(flat), (n_pol, n, n_chan), strides, off)
    return (flat[off:], (n_pol, n, n_chan), strides), view


def _fused_digest(n_chan: int, with_elem: bool, device, as_row: bool = False) -> str:
    """sha256 of inversion_fused's output bytes at SKA-Low (2 pol x 8
    blocks, time-major) or a slab (8 streams x 3 blocks, channel-major) of
    seeded noise, with a seeded (N,) elem (``as_row``: as a (1, N) table) or
    none: the case the kernel's output is held to bitwise across versions
    of the kernel."""
    import hashlib

    g = geometry.SynthesisGeometry(n_chan, L, OV, OS)
    c = tsynth.synthesis_constants(n_chan, L, OS, OV, temporal_taper="tukey",
                                   monotonic=n_chan == 216)
    consts = [torch.as_tensor(c["t_taper"], device=device),
              torch.as_tensor(np.linspace(0.5, 1.5, g.fn_width).astype(np.float32),
                              device=device),
              torch.as_tensor(c["perm"], device=device)]
    n_pol, nb = (2, 8) if n_chan == N_CHAN else (8, 3)
    n_dat = 2 * OV + nb * g.input_keep
    if n_chan == N_CHAN:
        x = torch.as_tensor(_noise((n_pol, n_dat, n_chan), 91), device=device)
    else:
        x = torch.as_tensor(_noise((n_pol, n_chan, n_dat), 92), device=device).transpose(1, 2)
    e = (torch.as_tensor(_noise((g.output_fft_length,), 93), device=device) if with_elem
         else None)
    if as_row:
        e = e[None]
    y = inv.inversion_fused(x, *consts, e, g.input_keep, (L // 2 + g.discard) % L, nb,
                            g.output_overlap, g.fn_width // 2, OS.de / OS.nu)
    return hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()


#: :func:`_fused_digest` on an H100 80GB HBM3 by the kernel as it was before
#: it took a (rows, N) elem table: with no elem or an (N,) one it gives the
#: same bits
FUSED_DIGESTS = {
    (256, False): "b4c3dbcafd877d51eeb261f19e8830ffbbb1037aaea4853fb8f9e1eeb2602e9e",
    (256, True): "c8d8a1bf9cc39697018541e73ae8ddc76764cd452de51bacebd5a3dc2c414f97",
    (216, False): "63e8d9a6383f298cd8b01b2c0a9eaf90bdbe91130e8484eabf74686ba631f90b",
    (216, True): "6c412447904b4c7386e4525ec863fb7157c2e8eefdca11291ecca244e6460720",
}


class TestInversionFused:
    """The fused inversion (ops/kernels/inversion_fused.py,
    csrc/inversion_fused.cu) on the CPU at its two geometries: its plain
    version, its predicate and tables, the route that takes it and the
    kernel's index maps in numpy."""

    @pytest.mark.parametrize("n_chan,n_l,ov,os_f,kw", [
        (N_CHAN, L, OV, OS, {}),                  # SKA-Low
        (216, L, OV, OS, {"monotonic": True}),    # a LowCBF PST slab
        (32, 64, 8, Rational(4, 3), {}),          # a reduced geometry: the plain version only
    ])
    @pytest.mark.parametrize("with_elem", [False, True])
    def test_plain_is_frontend_then_epilogue(self, n_chan, n_l, ov, os_f, kw, with_elem):
        g, consts, keep, kpos, lo, roll, gain, elem = _low_inversion_args(
            n_chan, n_l, ov, os_f, 70 if with_elem else None, **kw)
        x = torch.as_tensor(_noise((2, n_chan, 2 * ov + 3 * keep + 5), 71))[:, :, 5:]
        x_tc, nb, n = x.transpose(1, 2), 3, g.output_fft_length
        e = None if elem is None else torch.as_tensor(elem)
        got = inv.inversion_fused(x_tc, *consts, e, keep, kpos, nb, lo, roll, gain)
        fn = tsynth.frontend(x_tc, *consts, n_l, keep, kpos, nb)
        want = tsynth.epilogue(fn.reshape(2, nb, n), e, lo, roll, gain, nb)
        assert got.shape == (2, nb, g.output_keep) and torch.equal(got, want)
        if inv.takes(n_l, n_chan, n, lo):  # and the route it stands in for, on the CPU
            fn = synthesis_fused(x_tc, *consts, n_l, keep, kpos, nb)
            pair = tsf.epilogue_dispatch(fn.reshape(2, nb, n), e, g, spans_nyquist=True,
                                         n_valid=nb)
            assert torch.equal(got, pair)

    @pytest.mark.parametrize("geom,taken", [
        ((L, N_CHAN, N, LO), True),                           # SKA-Low
        ((256, 216, 41_472, 7_776), True),                    # a LowCBF PST slab
        ((256, 192, 36_864, 6_912), False),                   # the critical cascade's slab
        ((256, 216, 41_472, 7_776 + 216), True),              # a wider discard of whole rows
        ((256, 216, 41_472, 10_368), True),                   # a dedispersing PST node's
        ((256, 216, 41_472, 7_776 + 108), False),             # its neighbours: overlap,
        ((256, 224, 43_008, 8_064), False),                   # channels either side
        ((256, 208, 39_936, 7_488), False),
        ((1024, 216, 165_888, 31_104), False),                # another frame length
        ((512, 4096, 1_835_008, 458_752), False),             # SKA-Mid
        ((256, 512, 98_304, 18_432), False),                  # 512 channels at 4/3
        ((256, 128, 24_576, 4_608), False),                   # 128 channels: n1 = 192
        ((256, 256, 57_344, 7_168), False),                   # 256 channels at 8/7: n1 = 448
        ((256, 128, 16_384, 512), False),                     # an n1 = 128 split
        ((L, N_CHAN, N, LO + 64), False),                     # no plan: overlap not whole rows
        ((256, 216, 41_472, 20_736), False),                  # a discard that keeps nothing
        ((128, N_CHAN, N, LO), False),                        # another frame length
    ])
    def test_takes(self, geom, taken):
        assert inv.takes(*geom) == taken
        if geom[2] in (57_344, 16_384, 24_576):  # the cluster kernel's other splits
            assert itf.takes(*plan_ifft(*geom[2:]))
        if geom[1] in (216, 192):  # the cascades' slabs: no epilogue plan at all
            assert plan_ifft(*geom[2:]) is None

    @pytest.mark.parametrize("name", ["low", "128ch-4/3", "256ch-8/7", "512ch-4/3",
                                      "216ch-monotonic"])
    def test_route(self, name, monkeypatch):
        # fused_inversion launches the fused wrapper exactly where takes
        # holds, before any frontend, and the two-kernel route elsewhere
        n_chan, os_f, n_l, ov, kw = {
            "low": (N_CHAN, OS, L, OV, {}),
            "216ch-monotonic": (216, OS, L, OV, {"monotonic": True}),
        }.get(name, EXTRA.get(name, (None,) * 4)[:4] + ({},))
        g = geometry.SynthesisGeometry(n_chan, n_l, ov, os_f)
        c = tsynth.synthesis_constants(n_chan, n_l, os_f, ov, temporal_taper="tukey", **kw)
        consts = [torch.as_tensor(c[k]) for k in ("t_taper", "dr", "perm")]
        calls = []

        def spy(which, wrapped):
            def fn(*a, **k):
                calls.append(which)
                return wrapped(*a, **k)
            return fn

        monkeypatch.setattr(inv, "inversion_fused", spy("fused", inv.inversion_fused))
        monkeypatch.setattr(tsf, "synthesis_fused", spy("frontend", synthesis_fused))
        monkeypatch.setattr(tsf, "epilogue_plan", spy("plan", tsf.epilogue_plan))
        x = torch.as_tensor(_noise((2, 2 * ov + 2 * g.input_keep, n_chan), 72))
        composed = tsf.fused_inversion.composed_epilogues
        got = tsf.fused_inversion(x, *consts, None, g, spans_nyquist=True)
        taken = inv.takes(n_l, n_chan, g.output_fft_length, g.output_overlap)
        assert taken == (name in ("low", "216ch-monotonic"))
        assert calls == (["fused"] if taken else ["frontend", "plan"])
        assert tsf.fused_inversion.composed_epilogues == composed
        ref = tsynth.inversion_core(x, *consts, None, g, spans_nyquist=True)
        assert torch.equal(got, ref)

    @pytest.mark.parametrize("geom", sorted(FUSED_GEOMS))
    @pytest.mark.parametrize("with_elem", [False, True])
    @pytest.mark.parametrize("layout", ["time_major", "channel_major"])
    def test_kernel_emulation(self, geom, with_elem, layout):
        # csrc/inversion_fused.cu's index maps: the 16 * 16 frontend in two
        # halves a block, the roll folded into where each kept bin is
        # stored, the column buffers of eight blocks each slot written
        # once, the epilogue on them
        n_chan, kw = FUSED_GEOMS[geom]
        g, consts, keep, kpos, lo, roll, gain, elem = _low_inversion_args(
            n_chan, elem_seed=73 if with_elem else None, **kw)
        assert (roll, gain) == (96, 0.75)
        nb, ov = 2, g.input_overlap
        x, x_tc = _strided_input(2, 2 * ov + nb * keep, n_chan, layout, 74)
        got, stores = emu_inversion_fused(x, *(t.numpy() for t in consts), elem, keep, kpos,
                                          nb, lo, roll, gain)
        assert (stores == 1).all()  # every kept sample written exactly once
        ref = inv.inversion_fused(x_tc, *consts, None if elem is None else torch.as_tensor(elem),
                                  keep, kpos, nb, lo, roll, gain).numpy()
        assert _rel_err(got, ref) < SYNTHESIS_TOL

    @pytest.mark.parametrize("geom", sorted(FUSED_GEOMS))
    @pytest.mark.parametrize("seam", sorted(SEAMS))
    @pytest.mark.parametrize("layouts", [("time_major", "channel_major"),
                                         ("channel_major", "time_major")])
    def test_kernel_emulation_seam(self, geom, seam, layouts):
        # frame_load across the seam of a stream's held samples and its new
        # block, each with its own strides: the frames of the joined stream,
        # each frame wholly on one side read from that side, and the
        # kernel's output the plain version's on cat(held, x), which the
        # CPU branch of the wrapper computes from the pair, bit for bit
        n_chan, kw = FUSED_GEOMS[geom]
        g, consts, keep, kpos, lo, roll, gain, elem = _low_inversion_args(
            n_chan, elem_seed=95, **kw)
        nb = 5
        n_all = 2 * g.input_overlap + nb * keep
        h = SEAMS[seam](keep)
        held, held_t = _strided_input(2, h, n_chan, layouts[0], 96) if h else (None, None)
        x, x_tc = _strided_input(2, n_all - h, n_chan, layouts[1], 97)
        perm = consts[2].numpy()
        frames, sides = emu_frame_load(x, held, perm, keep, nb, L)
        assert sides == SEAM_SIDES[seam]
        joined = x_tc if held_t is None else torch.cat([held_t, x_tc], dim=1)
        flat = joined.contiguous().numpy().ravel()
        want, _ = emu_frame_load((flat, tuple(joined.shape), (n_all * n_chan, n_chan, 1)), None,
                                 perm, keep, nb, L)
        assert np.array_equal(frames, want)
        got, stores = emu_inversion_fused(x, *(t.numpy() for t in consts), elem, keep, kpos,
                                          nb, lo, roll, gain, held=held)
        assert (stores == 1).all()
        e = torch.as_tensor(elem)
        ref = inv.inversion_fused(joined, *consts, e, keep, kpos, nb, lo, roll, gain)
        assert _rel_err(got, ref.numpy()) < SYNTHESIS_TOL
        pair = inv.inversion_fused(x_tc, *consts, e, keep, kpos, nb, lo, roll, gain, held=held_t)
        assert torch.equal(pair, ref)

    @pytest.mark.parametrize("split", [False, True, "empty"])
    def test_launch_arguments(self, split, monkeypatch):
        # the wrapper's arguments to the C entry, on a fake library and meta
        # tensors: one for each argtype, the new block's strides then the
        # held samples' and the seam h (0 and none without them), the blocks
        # fitted to the h + n samples of both, and each launch of a pair
        # counted in split_launches; held samples of length 0 are a launch
        # on the new block alone (h = 0), not counted
        import contextlib
        import types

        from ska_pst_dsp_tpu_torch.ops import kernels

        calls = []
        lib = types.SimpleNamespace(inversion_fused_launch=lambda *a: calls.append(a) or 0)
        monkeypatch.setattr(kernels._build, "library", lambda: lib)
        monkeypatch.setattr(kernels, "on_card", lambda name, d: d)
        monkeypatch.setattr(kernels, "stream_of", lambda t: 99)
        monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        g, consts, keep, kpos, lo, roll, gain, _ = _low_inversion_args(
            216, monotonic=True)
        nb, h = 3, 0 if split == "empty" else 200
        n_all = 2 * g.input_overlap + nb * keep
        x_tc = torch.empty((4, 216, n_all - h + 5), dtype=torch.complex64,
                           device="meta")[:, :, 5:].transpose(1, 2)
        held = torch.empty((4, h, 216), dtype=torch.complex64, device="meta") if split else None
        consts = [t.to("meta") for t in consts]
        before = inv.inversion_fused.launches, inv.inversion_fused.split_launches
        if split is False:  # the new block alone holds too few samples for nb blocks
            with pytest.raises(ValueError, match="do not fit"):
                inv.inversion_fused(x_tc, *consts, None, keep, kpos, nb, lo, roll, gain)
            x_tc = torch.empty((4, 216, n_all), dtype=torch.complex64,
                               device="meta").transpose(1, 2)
        out = inv.inversion_fused(x_tc, *consts, None, keep, kpos, nb, lo, roll, gain, held=held)
        (args,) = calls
        assert len(args) == len(kernels._build.SIGNATURES["inversion_fused_launch"])
        assert args[13:16] == x_tc.stride() and args[-1] == 99
        assert args[16:20] == ((*held.stride(), h) if split else (0, 0, 0, 0))
        assert (args[1] is None) == (held is None)
        assert args[20:23] == (4, 216, nb) and out.shape == (4, nb, 25_920)
        assert (inv.inversion_fused.launches - before[0],
                inv.inversion_fused.split_launches - before[1]) == (1, int(split is True))

    def test_frontend_lanes_on_time(self):
        # csrc/inversion_fused.cu on a stream whose nearest axis is time (the
        # slab's kernel on the cascade's channel-major slabs): thread tid is
        # (c, j) = (tid // 16, tid % 16) in the first pass and (c, d) in the
        # second, so each warp's two rows are its own through both passes
        # and the spare threads of an 11-channel half are whole rows; the
        # skewed position 16*j + (d + j) % 16 takes every slot of a row
        # once, and a half-warp's 16 stores (one d) and 16 loads (one j) hit
        # 16 banks of 8 bytes in every row of 257 points
        tid = np.arange(256)
        assert {(w, c) for w, c in zip(tid // 32, tid // 16)} == {
            (w, 2 * w + i) for w in range(8) for i in (0, 1)}
        assert set(tid[tid // 16 >= 11] // 16) == set(range(11, 16))
        j, d = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
        pos = 16 * j + (d + j) % 16
        assert np.array_equal(np.sort(pos.ravel()), np.arange(256))
        for row in range(16):
            slots = (row * 257 + pos) % 16
            assert all(len(set(slots[:, k])) == 16 for k in range(16))  # first pass: one d
            assert all(len(set(slots[k, :])) == 16 for k in range(16))  # second pass: one j
        # a warp's loads: two channels' 16 consecutive samples, 128 bytes each
        t = tid % 16
        for w in range(8):
            lanes = slice(32 * w, 32 * w + 32)
            assert sorted(set(tid[lanes] // 16)) == [2 * w, 2 * w + 1]
            assert np.array_equal(t[lanes], np.tile(np.arange(16), 2))

    def test_radix6_passes(self):
        # the 216-point column transform on its per-pass table is the
        # backward DFT, in the output order the exchange assumes
        v = _noise((3, 216), 80)
        y = emu_radix6_passes(v, inv.radix6_pass_twiddles(216, 1))  # [.., g, d]
        g = np.arange(36)
        k2 = (g // 6 + 6 * (g % 6))[:, None] + 36 * np.arange(6)[None, :]
        want = np.fft.ifft(v.astype(np.complex128), axis=-1) * 216
        assert _rel_err(y, want[:, k2]) < 2e-6

    def test_tables(self):
        # SKA-Low's instance reads the cluster epilogue's tables, value for
        # value; the slab's split S = 36 and its radix-6 table
        low = inv.kernel_tables(N, 128, 384)
        ref = itf.cluster_tables(N, 384, ROLL)
        for k, r in (("tw_col", "tw_pass"), ("tw_n1", "tw_n1"), ("tw_a", "tw_a"),
                     ("tw_b", "tw_b"), ("tw_row", "tw_pass")):
            assert np.array_equal(low[k], ref[r]), k
        slab = inv.kernel_tables(41_472, 216, 192)
        assert {k: v.shape for k, v in slab.items()} == {
            "tw_col": (210,), "tw_n1": (192,), "tw_a": (6, 192), "tw_b": (36, 192),
            "tw_row": (126,)}
        m1 = np.arange(192)
        for k2 in (0, 35, 36, 215):  # w_N^(m1*k2) = tw_a[k2 // 36] * tw_b[k2 % 36]
            got = slab["tw_a"][k2 // 36] * slab["tw_b"][k2 % 36]
            assert np.abs(got - np.exp(2j * np.pi * m1 * k2 / 41_472)).max() < 2e-7

    @pytest.mark.parametrize("n_chan,n2,n1", [(256, 128, 384), (216, 216, 192)])
    def test_kernel_smem_two_blocks_an_sm(self, n_chan, n2, n1):
        # csrc/inversion_fused.cu InvPlan: columns, the receive buffer (which
        # holds the frontend's 16 rows of 257 points), the tables, the taper
        # and deripple fit twice in an SM's 228 KB, 1 KB a block reserved
        cols, recv, rows = n2 * (n1 // 8), (n2 // 8) * (n1 + 1), 16 * 257
        s = inv.TW_SPLIT[n2]
        tables = L + (126 if n2 == 128 else 210 + 126) + (n2 // s + s) * (n1 // 8)
        smem = 8 * (cols + recv + tables) + 4 * (L + 192)
        assert rows <= recv and 2 * (smem + 1024) <= 228 * 1024 and smem <= SMEM_LIMIT
        assert n_chan * 192 == n2 * n1 and (n_chan // 8) in (32, 27)

    @pytest.mark.parametrize("n_chan,kw", [(128, {}), (192, {"spans_nyquist": False})])
    def test_not_taken_raises_off_the_cpu(self, n_chan, kw):
        # the raw wrapper refuses another geometry from the predicate, before
        # anything is launched (a meta tensor: no data, no card); the
        # critical cascade's 192-channel slab among them
        g, consts, keep, kpos, lo, roll, gain, _ = _low_inversion_args(n_chan, **kw)
        x = torch.empty((1, 2 * OV + keep, n_chan), dtype=torch.complex64, device="meta")
        consts = [t.to("meta") for t in consts]
        before = inv.inversion_fused.launches
        with pytest.raises(ValueError, match="inversion_fused takes"):
            inv.inversion_fused(x, *consts, None, keep, kpos, 1, lo, roll, gain)
        assert inv.inversion_fused.launches == before


@pytest.mark.cuda
class TestOnCard:
    """Each kernel against its plain version on the card, at small shapes
    (chip_smoke.py does the same at the main path's shapes)."""

    @pytest.mark.parametrize("block,os_f,n_dat", [(256, OS, 100_000),
                                                  (512, Rational(8, 7), 40_001)])
    def test_analysis(self, cuda, filt, block, os_f, n_dat):
        # the low geometry's own fold, and the direct fold at a second
        # geometry with a ragged last tile and an odd stream length
        step = geometry.analysis_step(block, os_f)
        f = filt if block == N_CHAN else fir.design_pfb_fir_filter(block, os_f, 4)
        x = torch.as_tensor(_noise((2, n_dat), 19), device=cuda)
        f2d = torch.as_tensor(_prep_filter(f, block), device=cuda)
        ramp = torch.as_tensor(ramp_table(block, step), device=cuda)
        before = analysis_fused.launches
        got = analysis_fused(x, f2d, ramp, step, 3)
        assert analysis_fused.launches == before + 1
        ref = analysis_core(x, f2d, ramp, step, 3)
        assert (ref.shape[1] % af.tile_spectra(block)) != 0
        assert _rel_err(got.cpu(), ref.cpu()) < ANALYSIS_TOL

    def test_frontend(self, cuda, filt):
        c = tsynth.synthesis_constants(N_CHAN, L, OS, OV, deripple_coeff=filt,
                                       temporal_taper="tukey", combine=16)
        x = torch.as_tensor(_noise((2, N_CHAN, 1200), 20), device=cuda).transpose(1, 2)
        args = [torch.as_tensor(c[k], device=cuda) for k in ("t_taper", "dr", "perm")]
        nb = GEOM.n_blocks(1200)
        got = synthesis_fused(x, *args, L, GEOM.input_keep, KPOS, nb)
        ref = tsynth.frontend(x, *args, L, GEOM.input_keep, KPOS, nb)
        assert _rel_err(got.cpu(), ref.cpu()) < SYNTHESIS_TOL

    def test_frontend_mid_length(self, cuda):
        # L = 512 (the mid shape), time-major, 48 channels: a ragged tile
        os_f, ov, n_chan = Rational(8, 7), 128, 48
        geom = geometry.SynthesisGeometry(n_chan, 512, ov, os_f)
        c = tsynth.synthesis_constants(n_chan, 512, os_f, ov, temporal_taper="tukey")
        x = torch.as_tensor(_noise((2, 1500, n_chan), 41), device=cuda)
        args = [torch.as_tensor(c[k], device=cuda) for k in ("t_taper", "dr", "perm")]
        nb = geom.n_blocks(1500)
        kpos = (256 + geom.discard) % 512
        before = synthesis_fused.launches
        got = synthesis_fused(x, *args, 512, geom.input_keep, kpos, nb)
        assert synthesis_fused.launches == before + 1
        ref = tsynth.frontend(x, *args, 512, geom.input_keep, kpos, nb)
        assert _rel_err(got.cpu(), ref.cpu()) < SYNTHESIS_TOL

    @pytest.mark.parametrize("with_elem", [False, True])
    def test_inversion_fused_full_low(self, cuda, with_elem):
        # the low request's 2 pol x 272 blocks of time-major channels
        g, consts, keep, kpos, lo, roll, gain, elem = _low_inversion_args(
            elem_seed=75 if with_elem else None)
        nb = 272
        x = torch.as_tensor(_noise((2, 2 * OV + nb * keep, N_CHAN), 76), device=cuda)
        consts = [t.to(cuda) for t in consts]
        e = None if elem is None else torch.as_tensor(elem, device=cuda)
        before = inv.inversion_fused.launches
        got = inv.inversion_fused(x, *consts, e, keep, kpos, nb, lo, roll, gain)
        assert inv.inversion_fused.launches == before + 1
        fn = tsynth.frontend(x, *consts, L, keep, kpos, nb)
        ref = tsynth.epilogue(fn.reshape(2, nb, N), e, lo, roll, gain, nb)
        assert _rel_err(got.cpu(), ref.cpu()) < 4.7e-7

    @pytest.mark.parametrize("nb", [9, 18])
    @pytest.mark.parametrize("with_elem", [False, True])
    def test_inversion_fused_full_slab(self, cuda, nb, with_elem):
        # the cascade's inverse at full size: 512 slabs (2 pol x 256 coarse
        # channels) of 216 monotonic channels, 9 or 18 blocks, read through
        # the transposed view of a channel-major buffer, as the cascade's
        # inverse hands its slabs over
        g, consts, keep, kpos, lo, roll, gain, elem = _low_inversion_args(
            216, elem_seed=81 if with_elem else None, monotonic=True)
        n_dat = 2 * OV + nb * keep
        gen = torch.Generator(device=cuda).manual_seed(82 + nb)
        buf = torch.randn((512, 216, n_dat + 1000), dtype=torch.complex64, device=cuda,
                          generator=gen)
        x = buf[:, :, :n_dat].transpose(1, 2)
        consts = [t.to(cuda) for t in consts]
        e = None if elem is None else torch.as_tensor(elem, device=cuda)
        before = inv.inversion_fused.launches
        got = inv.inversion_fused(x, *consts, e, keep, kpos, nb, lo, roll, gain)
        assert inv.inversion_fused.launches == before + 1
        fn = tsynth.frontend(x, *consts, L, keep, kpos, nb)
        ref = tsynth.epilogue(fn.reshape(512, nb, g.output_fft_length), e, lo, roll, gain, nb)
        assert got.shape == ref.shape == (512, nb, 25_920)
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        assert err < SYNTHESIS_TOL

    @pytest.mark.parametrize("nb", [11, 22])
    def test_inversion_fused_chirp_table_slab(self, cuda, nb):
        # an SKA-Low PST node's request: 512 slabs (2 pol x 256 coarse
        # channels) of 216 monotonic channels at the node's discard (64 a
        # side: the taper's 48 and the chirp's reach), stream p reading row
        # p % 256 of a (256, 41472) table of chirps, through the transposed
        # view
        g, consts, keep, kpos, lo, roll, gain, _ = _low_inversion_args(
            216, ov=64, monotonic=True, taper_overlap=OV)
        n_dat = 2 * g.input_overlap + nb * keep
        gen = torch.Generator(device=cuda).manual_seed(84 + nb)
        buf = torch.randn((512, 216, n_dat + 1000), dtype=torch.complex64, device=cuda,
                          generator=gen)
        x = buf[:, :, :n_dat].transpose(1, 2)
        consts = [t.to(cuda) for t in consts]
        table = torch.as_tensor(dedispersion.Dedispersion(2.64476, 150.0, 0.78125).table(
            g.output_fft_length, 256, centred=True), device=cuda)
        before = inv.inversion_fused.launches
        got = inv.inversion_fused(x, *consts, table, keep, kpos, nb, lo, roll, gain)
        assert inv.inversion_fused.launches == before + 1
        fn = tsynth.frontend(x, *consts, L, keep, kpos, nb)
        ref = tsynth.epilogue(fn.reshape(512, nb, g.output_fft_length), table, lo, roll, gain,
                              nb)
        assert got.shape == ref.shape == (512, nb, 20_736)
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        assert err < SYNTHESIS_TOL
        # and each row is the one its stream reads: the table's rows rotated
        # by one give another answer on every stream
        off = inv.inversion_fused(x, *consts, table.roll(1, 0), keep, kpos, nb, lo, roll, gain)
        assert ((off - got).abs().amax(dim=(1, 2)) > 1e-3 * ref.abs().max()).all()

    @pytest.mark.parametrize("n_chan", [N_CHAN, 216])
    @pytest.mark.parametrize("with_elem", [False, True])
    def test_inversion_fused_bits_without_a_table(self, cuda, n_chan, with_elem):
        # no elem, or one (N,) factor: the bits of the kernel before it took
        # a table; and (1, N) the same bits as (N,)
        assert _fused_digest(n_chan, with_elem, cuda) == FUSED_DIGESTS[(n_chan, with_elem)]
        if with_elem:
            assert _fused_digest(n_chan, True, cuda, as_row=True) == FUSED_DIGESTS[(n_chan, True)]

    @pytest.mark.parametrize("nb", [1, 2, 3, 4])
    @pytest.mark.parametrize("layout", ["time_major", "channel_major", "offset_view"])
    def test_inversion_fused_stream_batches(self, cuda, nb, layout):
        # a stream block's 1-4 transforms a polarization; the streaming
        # stage's channel-major view, with and without a sample offset
        g, consts, keep, kpos, lo, roll, gain, elem = _low_inversion_args(elem_seed=77)
        n_dat = 2 * OV + nb * keep
        if layout == "time_major":
            x = torch.as_tensor(_noise((2, n_dat, N_CHAN), 78), device=cuda)
        else:
            off = 7 if layout == "offset_view" else 0
            x = torch.as_tensor(_noise((2, N_CHAN, n_dat + off), 78),
                                device=cuda)[:, :, off:].transpose(1, 2)
        consts = [t.to(cuda) for t in consts]
        for e in (None, torch.as_tensor(elem, device=cuda)):
            got = inv.inversion_fused(x, *consts, e, keep, kpos, nb, lo, roll, gain)
            fn = tsynth.frontend(x, *consts, L, keep, kpos, nb)
            ref = tsynth.epilogue(fn.reshape(2, nb, N), e, lo, roll, gain, nb)
            assert _rel_err(got.cpu(), ref.cpu()) < 4.7e-7

    @pytest.mark.parametrize("case", ["low", "low_elem", "slab216", "node216_table"])
    @pytest.mark.parametrize("seam", sorted(SEAMS))
    @pytest.mark.parametrize("layouts", [("channel_major", "channel_major"),
                                         ("time_major", "channel_major")])
    def test_inversion_fused_split_bits(self, cuda, case, seam, layouts):
        # both instantiations read a stream's held samples and its new block
        # across the seam: bit for bit the launch on the two joined, with
        # no elem, an (N,) one, or a PST node's (256, 41472) chirp table
        # over 512 streams; each such launch counted once in split_launches
        n_chan = N_CHAN if case.startswith("low") else 216
        kw = {} if n_chan == N_CHAN else {"monotonic": True}
        if case == "node216_table":
            kw.update(ov=64, taper_overlap=OV)
        g, consts, keep, kpos, lo, roll, gain, elem = _low_inversion_args(
            n_chan, elem_seed=98 if case == "low_elem" else None, **kw)
        consts = [t.to(cuda) for t in consts]
        e = None if elem is None else torch.as_tensor(elem, device=cuda)
        n_pol = 2
        if case == "node216_table":
            n_pol = 512
            e = torch.as_tensor(dedispersion.Dedispersion(2.64476, 150.0, 0.78125).table(
                g.output_fft_length, 256, centred=True), device=cuda)
        nb = 5
        n_all = 2 * g.input_overlap + nb * keep
        h = SEAMS[seam](keep)
        gen = torch.Generator(device=cuda).manual_seed(99)

        def part(n, layout):
            shape = (n_pol, n + 3, n_chan) if layout == "time_major" else (n_pol, n_chan, n + 3)
            buf = torch.randn(shape, dtype=torch.complex64, device=cuda, generator=gen)
            return buf[:, 3:] if layout == "time_major" else buf[:, :, 3:].transpose(1, 2)

        held = part(h, layouts[0]) if h else None
        x = part(n_all - h, layouts[1])
        joined = x if held is None else torch.cat([held, x], dim=1)
        want = inv.inversion_fused(joined, *consts, e, keep, kpos, nb, lo, roll, gain)
        before = inv.inversion_fused.split_launches
        got = inv.inversion_fused(x, *consts, e, keep, kpos, nb, lo, roll, gain, held=held)
        assert inv.inversion_fused.split_launches == before + (held is not None)
        assert torch.equal(got, want)

    def test_low_forward_launches_the_fused_inversion(self, cuda):
        # one low forward: the analysis and the fused inversion once each,
        # neither the frontend nor the cluster epilogue
        from ska_pst_dsp_tpu_torch.entry import low_round_trip
        from ska_pst_dsp_tpu_torch.ops.kernels import wrappers

        model = low_round_trip(cuda)
        x = torch.as_tensor(_noise((2, 2 ** 20), 79), device=cuda)
        ws = wrappers()
        before = {k: w.launches for k, w in ws.items()}
        out = model(x)
        ran = {k: w.launches - before[k] for k, w in ws.items() if w.launches != before[k]}
        assert ran == {"analysis_fused": 1, "inversion_fused": 1}
        assert _rel_err(out.cpu(), model.reference(x).cpu()) < SYNTHESIS_TOL

    @pytest.mark.parametrize("with_elem", [False, True])
    @pytest.mark.parametrize("n_b,n_valid", [(3, 2), (272, 272)])
    def test_epilogue(self, cuda, with_elem, n_b, n_valid):
        # n_valid < B, and the low main path's full batch of 272 blocks
        X = torch.as_tensor(_noise((2, n_b, N), 21), device=cuda)
        elem = torch.as_tensor(_noise((N,), 22), device=cuda) if with_elem else None
        before = fused_big_ifft.launches
        got = fused_big_ifft(X, elem, shape_key=(N, 128, 384, LO, ROLL, GAIN), n_valid=n_valid)
        assert fused_big_ifft.launches == before + 1
        ref = tsynth.epilogue(X, elem, LO, ROLL, GAIN, n_valid)
        assert _rel_err(got.cpu(), ref.cpu()) < SYNTHESIS_TOL

    def test_epilogue_n1_128(self, cuda):
        n, lo = 128 * 128, 512
        X = torch.as_tensor(_noise((2, 5, n), 47), device=cuda)
        elem = torch.as_tensor(_noise((n,), 48), device=cuda)
        got = fused_big_ifft(X, elem, shape_key=(n, 128, 128, lo, 31, 0.75), n_valid=4)
        ref = tsynth.epilogue(X, elem, lo, 31, 0.75, 4)
        assert _rel_err(got.cpu(), ref.cpu()) < SYNTHESIS_TOL

    @pytest.mark.parametrize("block,os_f,n_pol,spectra,extra", [
        (512, Rational(4, 3), 2, 80, 5), (1024, Rational(8, 7), 2, 80, 5),
        (4096, Rational(8, 7), 2, 200, 5),   # mid's own fold, cut, odd n_dat
        (4096, Rational(8, 7), 1, 70, 513),  # one polarization
        (4096, Rational(8, 7), 2, 9, 100),   # shorter than one tile
    ])
    def test_padded_fold(self, cuda, block, os_f, n_pol, spectra, extra):
        step = geometry.analysis_step(block, os_f)
        f = (np.random.default_rng(4).standard_normal(100353) if block == 4096
             else fir.design_pfb_fir_filter(block, os_f, 4))
        f2d_rev = torch.as_tensor(_prep_filter(f, block, reverse=True), device=cuda)
        x = torch.as_tensor(_noise((n_pol, spectra * step + extra), 31), device=cuda)
        ref = padded_fold(x, f2d_rev, step).cpu()
        before = apf.padded_fold_fused.launches
        # twice on the same tensors: a barrier left in the wrong phase, or a
        # row left from the first call, shows on the second
        for _ in range(2):
            got = apf.padded_fold_fused(x, f2d_rev, step)
            assert _rel_err(got.cpu(), ref) < PADDED_TOL
        assert apf.padded_fold_fused.launches == before + 2

    @pytest.mark.parametrize("n1,lo_rows,n_b,n_valid", [
        (192, 36, 5, 4),     # 3 * 64 on a cluster of four; n_valid < B
        (448, 56, 70, 70),   # 7 * 64 on a cluster of eight; more blocks than clusters
    ])
    @pytest.mark.parametrize("with_elem", [False, True])
    def test_epilogue_q64(self, cuda, n1, lo_rows, n_b, n_valid, with_elem):
        n, lo = 128 * n1, 128 * lo_rows
        X = torch.as_tensor(_noise((2, n_b, n), 56), device=cuda)
        elem = torch.as_tensor(_noise((n,), 57), device=cuda) if with_elem else None
        before = fused_big_ifft.launches
        for _ in range(2):  # a barrier left in the wrong phase shows on the second call
            got = fused_big_ifft(X, elem, shape_key=(n, 128, n1, lo, 37, 0.75),
                                 n_valid=n_valid)
            ref = tsynth.epilogue(X, elem, lo, 37, 0.75, n_valid)
            assert _rel_err(got.cpu(), ref.cpu()) < SYNTHESIS_TOL
        assert fused_big_ifft.launches == before + 2

    @pytest.mark.parametrize("name", list(EXTRA))
    def test_extra_geometries_on_kernels(self, cuda, name):
        # the drop-in runs the frontend and the epilogue on their kernels:
        # the cluster kernel, or the out-of-core pair for the 98304-point block
        n_chan, os_f, n_l, ov, split, kernel = EXTRA[name]
        f = fir.design_pfb_fir_filter(n_chan, os_f, 4)
        g = geometry.SynthesisGeometry(n_chan, n_l, ov, os_f)
        x = torch.as_tensor(_noise((2, n_chan, 2 * ov + 5 * g.input_keep), 51), device=cuda)
        kw = dict(input_overlap=ov, deripple_coeff=f, temporal_taper="tukey")
        ws = (synthesis_fused, fused_big_ifft, ifft_big_inner, ifft_big_outer)
        before = [w.launches for w in ws]
        got = polyphase_synthesis_fused(x, n_l, os_f, **kw)
        ran = [w.launches - b for w, b in zip(ws, before)]
        assert ran == ([1, 1, 0, 0] if kernel == "cluster" else [1, 0, 1, 1])
        ref = tsynth.polyphase_synthesis(x, n_l, os_f, **kw)
        assert _rel_err(got.cpu(), ref.cpu()) < SYNTHESIS_TOL

    @pytest.mark.parametrize("with_elem", [False, True])
    def test_mid_group_inversion(self, cuda, with_elem):
        # SKA-Mid's 256-channel groups (16 of 4096 channels, OS 8/7, L 512,
        # overlap 128): 114688 points on the pair at 896 x 128, with and
        # without a chirp as the spectral filter (the epilogue's elem)
        from ska_pst_dsp_tpu_torch.ops import dedispersion

        n_chan, os_f, n_l, ov = EXTRA["256ch-8/7-L512"][:4]
        f = fir.design_pfb_fir_filter(n_chan, os_f, 4)
        g = geometry.SynthesisGeometry(n_chan, n_l, ov, os_f)
        assert tsf.epilogue_plan(g.output_fft_length, g.output_overlap) == ("pair", 896, 128)
        h = (dedispersion.chirp_filter(n_chan * g.fn_width, 1.0, 1406.25, 2.5)
             if with_elem else None)
        x = torch.as_tensor(_noise((2, n_chan, 2 * ov + 6 * g.input_keep), 56), device=cuda)
        kw = dict(input_overlap=ov, deripple_coeff=f, temporal_taper="tukey",
                  spans_nyquist=False, spectral_filter=h)
        ws = (synthesis_fused, fused_big_ifft, ifft_big_inner, ifft_big_outer)
        before = [w.launches for w in ws]
        got = polyphase_synthesis_fused(x, n_l, os_f, **kw)
        assert [w.launches - b for w, b in zip(ws, before)] == [1, 0, 1, 1]
        ref = tsynth.polyphase_synthesis(x, n_l, os_f, **kw)
        assert _rel_err(got.cpu(), ref.cpu()) < SYNTHESIS_TOL

    def test_not_taken_raises_on_card(self, cuda, filt):
        # nothing on the card gives way to the plain version
        f = fir.design_pfb_fir_filter(2048, OS, 4)
        x = torch.as_tensor(_noise((1, f.size + 9 * 1536), 52), device=cuda)
        with pytest.raises(ValueError, match="takes blocks"):
            polyphase_analysis_fused(x, f, 2048, OS)
        f = fir.design_pfb_fir_filter(256, Rational(8, 7), 4)
        x = torch.as_tensor(_noise((2, 30 * 256), 53), device=cuda)
        with pytest.raises(ValueError, match="chan_dft_ramp takes blocks"):
            apf.polyphase_analysis_padded_fused(x, f, 256, Rational(8, 7))
        x = torch.as_tensor(_noise((1, N_CHAN, 2 * 48 + 2 * 288), 54), device=cuda)
        with pytest.raises(ValueError, match="takes L in"):
            polyphase_synthesis_fused(x, 384, OS, input_overlap=48, deripple_coeff=filt)

    @pytest.mark.parametrize("block", [1024, 4096, 512, 2048, 3072])
    def test_chan_dft(self, cuda, block):
        const = torch.as_tensor(padded_chan_const(block, block * 7 // 8), device=cuda)
        g = torch.as_tensor(_noise((2, 37, block), 32), device=cuda)
        before = chan_dft_ramp.launches
        got = chan_dft_ramp(g, const, 5, 14)
        assert chan_dft_ramp.launches == before + 1
        ref = chan_dft_core(g, const, 5, 14)
        assert _rel_err(got.cpu(), ref.cpu()) < PADDED_TOL

    @pytest.mark.parametrize("with_elem", [False, True])
    def test_ifft_big(self, cuda, with_elem):
        # 4 transforms of a reduced mid block: one launch of each kernel
        n2, n1, lo = 896, 512, 114_688
        n = n2 * n1
        X = torch.as_tensor(_noise((2, 2, n), 33), device=cuda)
        elem = torch.as_tensor(_noise((n,), 34), device=cuda) if with_elem else None
        before = (ifft_big_inner.launches, ifft_big_outer.launches)
        got = fused_big_ifft_oc(X, elem, shape_key=(n, 7, 128, n1, lo, 224, 0.875))
        assert (ifft_big_inner.launches, ifft_big_outer.launches) == (
            before[0] + 1, before[1] + 1)
        ref = tsynth.epilogue(X, elem, lo, 224, 0.875, 2)
        assert _rel_err(got.cpu(), ref.cpu()) < BIG_IFFT_TOL

    @pytest.mark.parametrize("with_elem", [False, True])
    def test_ifft_big_halves(self, cuda, with_elem):
        n2, n1, lo = 1536, 128, 12_288  # the (3, 512, 128) plan
        n = n2 * n1
        X = torch.as_tensor(_noise((2, 3, n), 36), device=cuda)
        elem = torch.as_tensor(_noise((n,), 37), device=cuda) if with_elem else None
        a = ifft_big_inner(X, elem, n2, n1)
        a_ref = tsynth.big_ifft_inner(X, elem, n2, n1)
        assert _rel_err(a.cpu(), a_ref.cpu()) < BIG_IFFT_TOL
        got = ifft_big_outer(a_ref, lo, 224, 0.875)
        ref = tsynth.big_ifft_outer(a_ref, lo, 224, 0.875)
        assert _rel_err(got.cpu(), ref.cpu()) < BIG_IFFT_TOL


#: (block, os, phases, step) of each analysis geometry the cascades run on
#: the card, with the ramp: sps stage 1 (25 phases at hop 216, a ramp of 32
#: rows, too large to stage in shared memory), the LowCBF firmware model (12
#: phases, the quarter-turn table of 4 rows, the direct fold) and low stage 2
CASCADE_ANALYSIS = {
    "sps": lambda rng: (_prep_filter(rng.standard_normal(6145), 256), ramp_table(256, 216), 216),
    "lowcbf": lambda rng: (lowcbf.lowcbf_filter(rng.standard_normal(3072)), lowcbf.lowcbf_ramp(),
                           192),
    "low": lambda rng: (_prep_filter(fir.design_pfb_fir_filter(256, OS, 12), 256),
                        ramp_table(256, 192), 192),
}


@pytest.mark.cuda
class TestCascadesOnCard:
    """The kernels at the geometries the streaming classes and the two-stage
    cascades give them, each against its plain version on the card."""

    @pytest.mark.parametrize("geom,shape,layout", [
        ("sps", (2, 40_001), "contiguous"), ("lowcbf", (2, 30_000), "contiguous"),
        ("lowcbf", (512, 3_999), "contiguous"),   # stage 2: 512 short streams, odd length
        ("low", (512, 4_001), "contiguous"), ("low", (3, 20_001), "contiguous"),
        ("low", (2, 30_000), "view"),      # a chunk of a longer buffer, read in place
        ("low", (2, 30_000), "view_odd"),  # one starting at an odd sample: copied
    ])
    def test_analysis(self, cuda, geom, shape, layout):
        rng = np.random.default_rng(60)
        f2d, ramp, step = (torch.as_tensor(t, device=cuda) if not isinstance(t, int) else t
                           for t in CASCADE_ANALYSIS[geom](rng))
        buf = torch.as_tensor(_noise((shape[0], shape[1] + 9), 61), device=cuda)
        x = {"contiguous": buf[:, :shape[1]].contiguous(), "view": buf[:, :shape[1]],
             "view_odd": buf[:, 1:shape[1] + 1]}[layout]
        before = analysis_fused.launches
        got = analysis_fused(x, f2d, ramp, step, 5)
        assert analysis_fused.launches == before + 1
        ref = analysis_core(x, f2d, ramp, step, 5)
        assert _rel_err(got.cpu(), ref.cpu()) < ANALYSIS_TOL

    @pytest.mark.parametrize("geom", ["sps", "lowcbf"])
    def test_channel_major_store(self, cuda, geom):
        # at the lowpsi.cascade cell's shapes (sps over 2 x (2^26 + a
        # carry), LowCBF over 512 streams of its spectra on the first call):
        # one launch, counted channel-major, bitwise the time-major store's
        # bins transposed
        f2d, ramp, step = (torch.as_tensor(t, device=cuda) if not isinstance(t, int) else t
                           for t in CASCADE_ANALYSIS[geom](np.random.default_rng(70)))
        t1 = (2 ** 26 + 7168 - 6400) // 216 // 32 * 32
        shape = (2, 6400 + t1 * 216) if geom == "sps" else (512, t1 + lowcbf.FIRST_CALL_PAD)
        bins = torch.as_tensor(np.arange(256) if geom == "sps" else lowcbf.kept_bins(),
                               device=cuda)
        g = torch.Generator(device=cuda).manual_seed(71)
        x = torch.complex(torch.randn(shape, generator=g, device=cuda),
                          torch.randn(shape, generator=g, device=cuda))
        before = analysis_fused.launches, analysis_fused.channel_major_launches
        got = analysis_fused(x, f2d, ramp, step, 3, rows=bins.to(torch.int32))
        assert (analysis_fused.launches - before[0],
                analysis_fused.channel_major_launches - before[1]) == (1, 1)
        want = analysis_fused(x, f2d, ramp, step, 3).index_select(-1, bins).transpose(1, 2)
        assert got.is_contiguous() and torch.equal(got, want)

    def test_pst_node_reads_its_chirps_on_the_fused_inversion(self, cuda):
        # an SKA-Low PST node (2 pol x 256 coarse channels x 216, dedispersed
        # at J0437-4715's DM, discarding 64 a side): one inversion_fused
        # launch over a (256, 41472) chirp table, no composed epilogue, the
        # plain versions' answer
        from ska_pst_dsp_tpu_torch.models.two_stage import TwoStageInverseFilterBank
        from ska_pst_dsp_tpu_torch.utils import profiling
        from ska_pst_dsp_tpu_torch.utils.config import load_config

        lowpsi = load_config("lowpsi")
        band = dedispersion.Dedispersion(2.64476, 150.0, 0.78125)
        x = torch.as_tensor(_noise((2, 256 * 216, 2 * 64 + 2 * 128), 72))
        got, want = (TwoStageInverseFilterBank(lowpsi, nch2=216, device=dev, dedispersion=band)
                     for dev in (cuda, "cpu"))
        before = profiling.counters()
        out = got.execute(got.init_state(), x.to(cuda))[1]
        after = profiling.counters()
        assert got._inv.elem.shape == (256, 216 * 192)
        assert after["inversion_fused"] - before["inversion_fused"] == 1
        assert after["composed_epilogues"] == before["composed_epilogues"]
        ref = want.execute(want.init_state(), x)[1]
        assert out.shape == ref.shape == (2, 256, 2 * 20_736)
        assert _rel_err(out.cpu(), ref) < SYNTHESIS_TOL

    def test_cascade_block_equals_time_major_stages(self, cuda):
        # one block of the cell (2 x 2^26) through SKA-Low's PST cascade and
        # through the same cascade over time-major stages, whose corner turns
        # copy: outputs, states and the inverse's output bitwise; two
        # channel-major launches and no corner-turn bytes
        from ska_pst_dsp_tpu_torch.models import streaming, two_stage
        from ska_pst_dsp_tpu_torch.utils import profiling
        from ska_pst_dsp_tpu_torch.utils.config import load_config

        sps, lowpsi = load_config("sps"), load_config("lowpsi")
        g = torch.Generator(device=cuda).manual_seed(72)
        x = torch.complex(torch.randn((2, 2 ** 26), generator=g, device=cuda),
                          torch.randn((2, 2 ** 26), generator=g, device=cuda))
        out = {}
        for side in ("time_major", "channel_major"):
            fb = two_stage.TwoStageFilterBank(sps, lowpsi, device=cuda)
            if side == "time_major":
                fb.stage1 = streaming.FilterBank(sps, device=cuda)
                fb.stage2 = streaming.FilterBank(lowpsi, device=cuda)
            inv = two_stage.TwoStageInverseFilterBank(sps, lowpsi, nch2=216, device=cuda)
            before = profiling.counters()
            state, y = fb.execute(fb.init_state(), x)
            _, z = inv.execute(inv.init_state(), y)
            after = profiling.counters()
            out[side] = (y, z, state, {k: after[k] - before[k] for k in (
                "analysis_fused_channel_major", "corner_turn_bytes")})
        (y0, z0, s0, c0), (y1, z1, s1, c1) = out["time_major"], out["channel_major"]
        assert y1.shape == (2, 256 * 216, y1.shape[2]) and y1.shape[2] > 0 and z1.shape[2] > 0
        assert torch.equal(y1, y0) and torch.equal(z1, z0)
        for a, b in ((s1.stage1, s0.stage1), (s1.stage2, s0.stage2)):
            assert (a.base, a.emitted) == (b.base, b.emitted) and torch.equal(a.buffer, b.buffer)
        assert c1 == {"analysis_fused_channel_major": 2, "corner_turn_bytes": 0}
        assert c0["analysis_fused_channel_major"] == 0 and c0["corner_turn_bytes"] > 0

    @pytest.mark.parametrize("n_chan,kw,n_slab,launched,composed", [
        (216, {"monotonic": True}, 6, {"inversion_fused": 1}, 0),        # lowpsi slabs, fused
        (192, {"spans_nyquist": False}, 6, {"synthesis_fused": 1}, 1),   # critical, composed
        (3072, {"spans_nyquist": False, "combine": 16}, 2,               # the pair
         {"synthesis_fused": 1, "ifft_big_inner": 1, "ifft_big_outer": 1}, 0),
    ])
    def test_inversion(self, cuda, filt, n_chan, kw, n_slab, launched, composed):
        # channel-major slabs read time-major: the fused inversion where it
        # takes the geometry, else the frontend kernel and the epilogue the
        # dispatch picks
        from ska_pst_dsp_tpu_torch.ops.kernels import wrappers

        g = geometry.SynthesisGeometry(n_chan, L, OV, OS)
        c = tsynth.synthesis_constants(n_chan, L, OS, OV, deripple_coeff=filt,
                                       temporal_taper="tukey", **kw)
        x = torch.as_tensor(_noise((n_slab, n_chan, 2 * OV + 3 * g.input_keep), 62),
                            device=cuda).transpose(1, 2)
        args = [torch.as_tensor(c[k], device=cuda) for k in ("t_taper", "dr", "perm")]
        spans = kw.get("spans_nyquist", True)
        ws = wrappers()
        before = {k: w.launches for k, w in ws.items()}
        composed0 = tsf.fused_inversion.composed_epilogues
        got = tsf.fused_inversion(x, *args, None, g, spans_nyquist=spans)
        assert {k: w.launches - before[k] for k, w in ws.items()
                if w.launches != before[k]} == launched
        assert tsf.fused_inversion.composed_epilogues - composed0 == composed
        ref = tsynth.inversion_core(x, *args, None, g, spans_nyquist=spans)
        assert _rel_err(got.cpu(), ref.cpu()) < SYNTHESIS_TOL

    @pytest.mark.parametrize("with_elem", [False, True])
    def test_ifft_big_589824(self, cuda, with_elem):
        # the critical combine-16 inversion's 589824 points on 1536 x 384
        n, lo = 589_824, 110_592
        route, n2, n1 = tsf.epilogue_plan(n, lo)
        X = torch.as_tensor(_noise((2, 2, n), 63), device=cuda)
        elem = torch.as_tensor(_noise((n,), 64), device=cuda) if with_elem else None
        got = fused_big_ifft_oc(X, elem, shape_key=(n, 1, n2, n1, lo, 0, 0.75))
        ref = tsynth.epilogue(X, elem, lo, 0, 0.75, 2)
        assert (route, n2, n1) == ("pair", 1536, 384)
        assert _rel_err(got.cpu(), ref.cpu()) < BIG_IFFT_TOL

    @pytest.mark.parametrize("name,chunks", [("low", [100_001, 333_333, 250_000]),
                                             ("lowpsi", [50_001, 200_000]),
                                             ("mid", [1_000_000, 1_500_001])])
    def test_streaming_equals_oneshot(self, cuda, name, chunks):
        from ska_pst_dsp_tpu_torch.models.streaming import FilterBank, InverseFilterBank
        from ska_pst_dsp_tpu_torch.ops.kernels.analysis_padded_fused import (
            polyphase_analysis_padded_fused,
        )
        from ska_pst_dsp_tpu_torch.utils.config import load_config

        cfg = load_config(name)
        f = cfg.load_fir_filter_coeff()
        x = torch.as_tensor(_noise((2, sum(chunks)), 65), device=cuda)
        fb, inv = FilterBank(cfg, device=cuda), InverseFilterBank(cfg, device=cuda)
        fs, ist, chans, outs, pos = fb.init_state(), inv.init_state(), [], [], 0
        for c in chunks:
            fs, y = fb.execute(fs, x[:, pos:pos + c])
            ist, z = inv.execute(ist, y)
            chans.append(y)
            outs.append(z)
            pos += c
        chan, out = torch.cat(chans, 2), torch.cat(outs, 2)
        one = {"low": lambda: polyphase_analysis_fused(x, f, 256, cfg.os_factor),
               "lowpsi": lambda: lowcbf.polyphase_analysis_lowcbf(x, f),
               "mid": lambda: polyphase_analysis_padded_fused(x, f, 4096, cfg.os_factor)}[name]()
        assert chan.shape[2] > 0 and _rel_err(chan.cpu(), one[:, :, :chan.shape[2]].cpu()) < 1e-6
        if name == "lowpsi":
            return
        ref = polyphase_synthesis_fused(chan, cfg.input_fft_length, cfg.os_factor,
                                        input_overlap=cfg.input_overlap, deripple_coeff=f,
                                        temporal_taper="tukey")
        assert out.shape[2] > 0 and _rel_err(out.cpu(), ref[:, :, :out.shape[2]].cpu()) < 1e-6
