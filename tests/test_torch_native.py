"""The port's DADA ingest engine (ska_pst_dsp_tpu_torch.io.native,
io.dada.load_split and the kernels of ops.kernels.dada_unpack) on the CPU.

Every read, write and load is held bitwise to the JAX package's native C++
engine (``ska_pst_dsp_tpu.io.native``, through the ``jax_native``
fixture), and the reads also to JAX's numpy ``dada.load``, so that not
every check hangs on the native library. Inputs are made with numpy from a
seed. A numpy emulation of each CUDA kernel's index map (tiles, ragged
edges, the grid-stride loop) is held to the plain versions the CPU runs.
Tests marked ``cuda`` hold each kernel to its plain version on a card and
skip without one; JAX is imported only inside the fixtures that need it,
so on a machine with a card and no JAX they run with ``python -m pytest
--noconftest tests/test_torch_native.py -m cuda``.
"""

import os

import numpy as np
import pytest
import torch

from ska_pst_dsp_tpu_torch.io import dada, native
from ska_pst_dsp_tpu_torch.ops import kernels
from ska_pst_dsp_tpu_torch.ops.kernels import dada_unpack as du
from ska_pst_dsp_tpu_torch.parallel import distributed as dist_
from ska_pst_dsp_tpu_torch.parallel import sharded as sh

NBITS = (8, 16, 32, 64)
WORD = {8: np.int8, 16: np.int16, 32: np.float32, 64: np.float64}
#: samples of a test file by channel count (odd: every window is ragged)
N_DAT = {1: 1537, 3: 401, 256: 75}
#: name -> (first sample, count) of a file of n samples
WINDOWS = {"start": lambda n: (0, n // 3), "middle": lambda n: (n // 4 + 3, n // 2 + 1),
           "end": lambda n: (n - n // 3 - 1, n // 3 + 1)}
HEAPS = 7
LOWCBF_WINDOWS = ((0, HEAPS), (0, 2), (3, 3), (4, 3))


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's native engine, loaded. Workers that import the
    package's tests at once each run ``make`` where native/libdada_engine.so
    is missing, and a worker that opens a library another is still writing
    memoises the failure; by the time a test runs the library is whole, so
    the memo is reset and the library loaded once more. A library still
    missing fails the test."""
    from ska_pst_dsp_tpu.io import native as jax_native_module

    if not jax_native_module.available():
        monkeypatch.setattr(jax_native_module, "_lib", None)
        monkeypatch.setattr(jax_native_module, "_tried", False)
        assert jax_native_module.available(), (
            f"the JAX native engine does not load ({jax_native_module._LIB_PATH})")
    return jax_native_module


def test_jax_native_recovers_a_memoised_failure(monkeypatch, request):
    # a worker that lost the build race: load failed once, memoised
    from ska_pst_dsp_tpu.io import native as jax_native_module

    monkeypatch.setattr(jax_native_module, "_lib", None)
    monkeypatch.setattr(jax_native_module, "_tried", True)
    assert not jax_native_module.available()
    assert request.getfixturevalue("jax_native").available()


@pytest.fixture
def jax_dada():
    from ska_pst_dsp_tpu.io import dada as jax_dada_module

    return jax_dada_module


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _words(shape, nbit, seed):
    """Seeded words of one NBIT: integers over the whole range, floats with
    digits float32 cannot hold (float64) and signed zeros."""
    rng = np.random.default_rng(seed)
    if nbit <= 16:
        info = np.iinfo(WORD[nbit])
        return rng.integers(info.min, info.max + 1, size=shape).astype(WORD[nbit])
    w = (rng.standard_normal(shape) * 1000 + rng.standard_normal(shape) * 1e-9).astype(WORD[nbit])
    w.ravel()[:2] = (0.0, -0.0)
    return w


def _write(path, words, **header):
    """A DADA file of raw words (any shape, written in order) behind a
    header of NDIM 2 and the given keys."""
    hdr = {"NDIM": "2", **{k: str(v) for k, v in header.items()}}
    with open(path, "wb") as f:
        f.write(dada.serialize_header(hdr))
        words.tofile(f)
    return str(path)


def _tfp_file(tmp_path, nbit, n_pol, n_chan, n_dat, seed=0):
    words = _words((n_dat, n_chan, n_pol, 2), nbit, seed)
    return _write(tmp_path / f"x{nbit}.dada", words, NBIT=nbit, NPOL=n_pol, NCHAN=n_chan)


def _lowcbf_file(tmp_path, nbit, n_pol, n_chan, n_heaps=HEAPS, seed=1):
    words = _words((n_heaps, n_chan, n_pol, 32, 2), nbit, seed)
    return _write(tmp_path / f"lc{nbit}.dada", words, NBIT=nbit, NPOL=n_pol, NCHAN=n_chan,
                  INSTRUMENT="LowCBF")


def _bits(x):
    """The float32 bits of a complex64 tensor or of (re, im) planes."""
    if isinstance(x, torch.Tensor):
        return torch.view_as_real(x.cpu()).numpy().view(np.uint32)
    re, im = x
    return np.stack([np.asarray(re), np.asarray(im)], axis=-1).astype(np.float32).view(np.uint32)


def _equal_to_numpy_path(got, ref):
    """got equals JAX's numpy read ``ref`` cast to complex64, value for
    value: that path builds re + 1j * im, which turns an imaginary -0.0
    into +0.0, so its bits are not the file's."""
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(ref).astype(np.complex64))


# --- reads against the JAX engine and JAX's numpy load ------------------------

@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("n_chan", sorted(N_DAT))
@pytest.mark.parametrize("n_pol", [1, 2])
@pytest.mark.parametrize("nbit", NBITS)
def test_read_split(jax_native, tmp_path, nbit, n_pol, n_chan, window):
    n = N_DAT[n_chan]
    path = _tfp_file(tmp_path, nbit, n_pol, n_chan, n)
    start, count = WINDOWS[window](n)
    hdr = native.header_size(path)
    got = native.read_split(path, hdr, n_pol, n_chan, nbit, start, count, device="cpu")
    ref = jax_native.read_split(path, hdr, n_pol, n_chan, nbit, start, count)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (n_pol, n_chan, count)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    if window == "end":
        assert start + count == n


@pytest.mark.parametrize("n_chan", sorted(N_DAT))
@pytest.mark.parametrize("n_pol", [1, 2])
@pytest.mark.parametrize("nbit", NBITS)
def test_read_split_vs_numpy_load(jax_dada, tmp_path, nbit, n_pol, n_chan):
    # JAX's numpy path reads float64 words as complex128: cast to complex64
    # they are float64 -> float32 rounded to nearest, as the engines round;
    # the bitwise comparisons are test_read_split's
    n = N_DAT[n_chan]
    path = _tfp_file(tmp_path, nbit, n_pol, n_chan, n, seed=2)
    for window in WINDOWS.values():
        start, count = window(n)
        got = native.read_split(path, 4096, n_pol, n_chan, nbit, start, count, device="cpu")
        ref, _ = jax_dada.load(path, count=count, offset_samples=start)
        _equal_to_numpy_path(got, ref)


@pytest.mark.parametrize("n_chan", [1, 3, 256])
@pytest.mark.parametrize("n_pol", [1, 2])
@pytest.mark.parametrize("nbit", [8, 16, 32])
def test_read_lowcbf_split(jax_native, tmp_path, nbit, n_pol, n_chan):
    path = _lowcbf_file(tmp_path, nbit, n_pol, n_chan)
    for start, n_heaps in LOWCBF_WINDOWS:
        got = native.read_lowcbf_split(path, 4096, n_pol, n_chan, nbit, start, n_heaps,
                                       device="cpu")
        ref = jax_native.read_lowcbf_split(path, 4096, n_pol, n_chan, nbit, start, n_heaps)
        assert tuple(got.shape) == (n_pol, n_chan, 32 * n_heaps)
        np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("nbit", [8, 16, 32])
def test_read_lowcbf_split_vs_numpy_load(jax_dada, tmp_path, nbit):
    path = _lowcbf_file(tmp_path, nbit, 2, 3, seed=3)
    for start, n_heaps in LOWCBF_WINDOWS:
        got = native.read_lowcbf_split(path, 4096, 2, 3, nbit, start, n_heaps, device="cpu")
        ref, _ = jax_dada.load(path, count=32 * n_heaps, offset_samples=32 * start)
        _equal_to_numpy_path(got, ref)


@pytest.mark.parametrize("kind", ["tfp", "lowcbf"])
def test_window_past_the_end_raises(jax_native, tmp_path, kind):
    if kind == "tfp":
        path = _tfp_file(tmp_path, 16, 2, 3, 100)
        args = (path, 4096, 2, 3, 16, 90, 11)
        port, jax_fn = native.read_split, jax_native.read_split
    else:
        path = _lowcbf_file(tmp_path, 16, 2, 3)
        args = (path, 4096, 2, 3, 16, HEAPS - 2, 3)
        port, jax_fn = native.read_lowcbf_split, jax_native.read_lowcbf_split
    with pytest.raises(IOError):
        jax_fn(*args)
    with pytest.raises(IOError, match="past the end"):
        port(*args, device="cpu")
    # the last whole window reads
    last = args[:-1] + (args[-1] - 1,)
    np.testing.assert_array_equal(_bits(port(*last, device="cpu")), _bits(jax_fn(*last)))


@pytest.mark.parametrize("call", ["read_split", "read_lowcbf_split", "append_split"])
def test_unsupported_nbit_raises(jax_native, tmp_path, call):
    # the JAX engine returns code 3 (IOError); the port raises ValueError
    # before it reads or writes a byte
    path = _tfp_file(tmp_path, 64, 1, 1, 64)
    size = os.path.getsize(path)
    with pytest.raises(ValueError, match="NBIT"):
        if call == "append_split":
            native.append_split(path, torch.zeros((1, 1, 4), dtype=torch.complex64), nbit=64)
        else:
            getattr(native, call)(path, 4096, 1, 1, 64 if call != "read_split" else 12, 0, 1,
                                  device="cpu")
    with pytest.raises(IOError):
        if call == "append_split":
            jax_native.append_split(path, np.zeros((1, 1, 4), np.float32),
                                    np.zeros((1, 1, 4), np.float32), nbit=64)
        else:
            getattr(jax_native, call)(path, 4096, 1, 1, 64 if call != "read_split" else 12, 0, 1)
    assert os.path.getsize(path) == size


@pytest.mark.parametrize("hdr_size", [4096, 8192, 16384])
def test_header_size(jax_native, tmp_path, hdr_size):
    path = _write(tmp_path / "h.dada", np.zeros(8, np.float32), HDR_SIZE=hdr_size, NBIT=32,
                  NPOL=1, NCHAN=1)
    assert native.header_size(path) == jax_native.header_size(path) == hdr_size


@pytest.mark.parametrize("text", [b"NBIT 8\nNPOL 2\n", b"HDR_SIZE x\n", b"HDR_SIZE -4096\n",
                                  b"NBIT 8\n\x00HDR_SIZE 4096\n"])
def test_header_size_unparseable(jax_native, tmp_path, text):
    path = tmp_path / "bad.dada"
    path.write_bytes(text + b"\x00" * 100)
    for fn in (native.header_size, jax_native.header_size):
        with pytest.raises(ValueError, match="HDR_SIZE"):
            fn(str(path))


# --- writes --------------------------------------------------------------------

def _to_write(n_pol, n_chan, n_dat, scale, seed):
    """complex64 samples whose products with ``scale`` sit at k + 0.5 (the
    even rounding), beyond both clips, and elsewhere at random."""
    rng = np.random.default_rng(seed)
    shape = (n_pol, n_chan, n_dat)
    v = rng.standard_normal(shape + (2,)) * 60
    halves = (np.arange(-40, 40) + 0.5) / scale
    flat = v.reshape(-1)
    flat[: halves.size] = halves
    flat[halves.size:halves.size + 4] = (1e6, -1e6, 40000.0, -40000.0)
    return torch.view_as_complex(torch.as_tensor(v.astype(np.float32)).contiguous())


@pytest.mark.parametrize("shape", [(1, 1, 301), (2, 3, 97), (2, 256, 9)])
@pytest.mark.parametrize("nbit", [8, 16, 32])
def test_append_split(jax_native, tmp_path, nbit, shape):
    scale = 2.0 if nbit != 32 else 0.37
    x = _to_write(*shape, scale, seed=nbit)
    port, ref = (_write(tmp_path / f"{k}.dada", np.zeros(0, np.int8), NBIT=nbit,
                        NPOL=shape[0], NCHAN=shape[1]) for k in ("port", "jax"))
    for part in (x[..., :5], x[..., 5:]):  # two appends
        native.append_split(port, part, nbit=nbit, scale=scale)
        jax_native.append_split(ref, part.real.numpy().copy(), part.imag.numpy().copy(),
                                nbit=nbit, scale=scale)
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(port) == 4096 + x.numel() * nbit // 4


@pytest.mark.parametrize("nbit", [8, 16, 32])
def test_pack_vs_numpy_save(jax_dada, tmp_path, nbit):
    # JAX's numpy save writes the same words (np.round is half to even)
    x = _to_write(2, 3, 50, 1.0, seed=10 + nbit)
    path = str(tmp_path / "s.dada")
    jax_dada.save(path, x.numpy(), {}, nbit=nbit)
    with open(path, "rb") as f:
        words = f.read()[4096:]
    assert bytes(du.dada_pack(x, nbit).numpy()) == words


def test_append_then_load_split_gives_the_quantised_stream(tmp_path):
    x = _to_write(2, 3, 64, 3.0, seed=5)
    path = _write(tmp_path / "w.dada", np.zeros(0, np.int8), NBIT=8, NPOL=2, NCHAN=3)
    native.append_split(path, x, nbit=8, scale=3.0)
    got, hdr = dada.load_split(path, device="cpu")
    v = torch.view_as_real(x) * 3.0
    want = torch.view_as_complex(torch.round(v).clamp(-128, 127).contiguous())
    assert torch.equal(got, want) and hdr["NBIT"] == "8"


# --- load_split ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["whole", "window", "from_offset", "lowcbf", "lowcbf_window"])
def test_load_split(jax_native, tmp_path, case):
    from ska_pst_dsp_tpu.io import dada as jax_dada_module

    lowcbf = case.startswith("lowcbf")
    path = (_lowcbf_file(tmp_path, 16, 2, 3) if lowcbf
            else _tfp_file(tmp_path, 16, 2, 3, 401, seed=6))
    kw = {"whole": {}, "window": dict(count=100, offset_samples=37),
          "from_offset": dict(offset_samples=250), "lowcbf": {},
          "lowcbf_window": dict(count=64, offset_samples=96)}[case]
    got, hdr = dada.load_split(path, device="cpu", **kw)
    re, im, ref_hdr = jax_dada_module.load_split(path, **kw)
    assert hdr == ref_hdr and tuple(got.shape) == re.shape
    np.testing.assert_array_equal(_bits(got), _bits((re, im)))


@pytest.mark.parametrize("case", ["ndim1", "part_heap", "part_offset"])
def test_load_split_errors(jax_dada, tmp_path, case):
    if case == "ndim1":
        path = _write(tmp_path / "r.dada", np.zeros(64, np.float32), NDIM=1, NBIT=32, NPOL=1,
                      NCHAN=1)
        kw, match = {}, "NDIM=2"
    else:
        path = _lowcbf_file(tmp_path, 16, 2, 3)
        kw = dict(count=40) if case == "part_heap" else dict(count=32, offset_samples=16)
        match = "whole 32-sample heaps"
    with pytest.raises(ValueError, match=match):
        dada.load_split(path, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        jax_dada.load_split(path, **kw)


def test_load_split_unsupported_nbit(tmp_path):
    path = _write(tmp_path / "w.dada", np.zeros(64, np.int8), NBIT=4, NPOL=1, NCHAN=1)
    with pytest.raises(ValueError, match="NBIT=4"):
        dada.load_split(path, device="cpu")
    lc = _lowcbf_file(tmp_path, 32, 1, 1)
    with open(lc, "r+b") as f:  # a float64 LowCBF header: the LowCBF read takes none
        head = f.read(4096)
        f.seek(0)
        f.write(head.replace(b"NBIT 32", b"NBIT 64"))
    with pytest.raises(ValueError, match="NBIT=64"):
        dada.load_split(lc, device="cpu")


@pytest.mark.parametrize("case", ["nbit8", "nbit16", "nbit32", "nbit64", "lowcbf"])
def test_load_dada_sharded_world_1(jax_native, tmp_path, case):
    """One rank, no spawn: the port's per-rank ingest equals the JAX
    package's (through its native engine) on a one-device mesh, and the
    port's numpy read."""
    from ska_pst_dsp_tpu.parallel import distributed as jdist
    from ska_pst_dsp_tpu.parallel import sharded as jsh

    if case == "lowcbf":  # the JAX package reads whole heaps only: the whole file
        path, count = _lowcbf_file(tmp_path, 16, 2, 1), None
    else:
        path, count = _tfp_file(tmp_path, int(case[4:]), 2, 1, 1000, seed=7), 995
    got, hdr = dist_.load_dada_sharded(path, sh.make_mesh(device="cpu"), count=count)
    (gr, gi), ref_hdr = jdist.load_dada_sharded(path, jsh.make_mesh(1), count=count)
    assert hdr == ref_hdr and got.shape == (2, gr.shape[-1])
    np.testing.assert_array_equal(_bits(got), _bits((gr, gi)))
    full, _ = dada.load(path, count=got.shape[-1])
    _equal_to_numpy_path(got, full[:, 0])


# --- the kernels' index maps, emulated -----------------------------------------

def _tile_grid(w, count):
    log_tc = du.tile_columns(w)
    tc, tt = 1 << log_tc, du.TILE >> log_tc
    return tc, tt, -(-count // tt), -(-w // tc)


def emu_unpack(pairs, n_pol, n_chan, count):
    """csrc/dada_unpack.cu dada_unpack_kernel: every block's tile loaded
    column fastest, stored sample fastest, through rows of tt + 1. pairs:
    (count * w, 2) float32 words. Returns the output and how often each
    output sample and input pair was touched."""
    w = n_pol * n_chan
    tc, tt, gx, gy = _tile_grid(w, count)
    out = np.full((n_pol * n_chan * count, 2), np.nan, np.float32)
    writes, reads = np.zeros(out.shape[0], int), np.zeros(pairs.shape[0], int)
    i = np.arange(du.TILE)
    for bx in range(gx):
        for by in range(gy):
            t0, c0 = bx * tt, by * tc
            tile = np.full((du.TILE + 32, 2), np.nan, np.float32)
            c, t = i & (tc - 1), i >> (tc.bit_length() - 1)
            ok = (t0 + t < count) & (c0 + c < w)
            src = (t0 + t[ok]) * w + c0 + c[ok]
            tile[c[ok] * (tt + 1) + t[ok]] = pairs[src]
            np.add.at(reads, src, 1)
            t, c = i & (tt - 1), i >> (tt.bit_length() - 1)
            col = c0 + c
            ok = (t0 + t < count) & (col < w)
            p, f = col[ok] % n_pol, col[ok] // n_pol
            dst = (p * n_chan + f) * count + t0 + t[ok]
            out[dst] = tile[c[ok] * (tt + 1) + t[ok]]
            np.add.at(writes, dst, 1)
    return out, writes, reads


def emu_pack(planes, n_pol, n_chan, count):
    """dada_pack_kernel's index map (the quantisation aside): planes
    (n_pol * n_chan * count, 2) -> TFP pairs (count * w, 2)."""
    w = n_pol * n_chan
    tc, tt, gx, gy = _tile_grid(w, count)
    raw = np.full((count * w, 2), np.nan, np.float32)
    writes = np.zeros(raw.shape[0], int)
    i = np.arange(du.TILE)
    for bx in range(gx):
        for by in range(gy):
            t0, c0 = bx * tt, by * tc
            tile = np.full((du.TILE + 32, 2), np.nan, np.float32)
            t, c = i & (tt - 1), i >> (tt.bit_length() - 1)
            col = c0 + c
            ok = (t0 + t < count) & (col < w)
            p, f = col[ok] % n_pol, col[ok] // n_pol
            tile[c[ok] * (tt + 1) + t[ok]] = planes[(p * n_chan + f) * count + t0 + t[ok]]
            c, t = i & (tc - 1), i >> (tc.bit_length() - 1)
            ok = (t0 + t < count) & (c0 + c < w)
            dst = (t0 + t[ok]) * w + c0 + c[ok]
            raw[dst] = tile[c[ok] * (tt + 1) + t[ok]]
            np.add.at(writes, dst, 1)
    return raw, writes


def emu_lowcbf(pairs, n_pol, n_chan, n_heaps, blocks, threads=256):
    """lowcbf_unpack_kernel's grid-stride loop: thread g of the grid takes
    pairs g, g + blocks * threads, ..."""
    w = n_pol * n_chan
    n_samp = n_heaps * 32
    total = n_samp * w
    out = np.full((total, 2), np.nan, np.float32)
    writes = np.zeros(total, int)
    for g0 in range(0, total, blocks * threads):
        i = np.arange(g0, min(total, g0 + blocks * threads))
        t, packet = i & 31, i // 32
        c, h = packet % w, packet // w
        dst = ((c % n_pol) * n_chan + c // n_pol) * n_samp + h * 32 + t
        out[dst] = pairs[i]
        np.add.at(writes, dst, 1)
    return out, writes


#: (n_pol, n_chan, count): one and two columns, a ragged column tile
#: (3, 5, 6 columns), whole and ragged 32-column tiles, ragged sample tiles
EMU_SHAPES = [(1, 1, 2049), (2, 1, 1025), (1, 3, 300), (2, 3, 257), (1, 5, 130),
              (2, 16, 95), (2, 256, 33), (1, 40, 70)]


@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_unpack_index_map(shape):
    n_pol, n_chan, count = shape
    words = _words((count, n_chan, n_pol, 2), 32, 11)
    got, writes, reads = emu_unpack(words.reshape(-1, 2), n_pol, n_chan, count)
    assert (writes == 1).all() and (reads == 1).all()
    ref = du.dada_unpack(torch.from_numpy(words.view(np.uint8).reshape(-1)), 32, *shape)
    np.testing.assert_array_equal(got, torch.view_as_real(ref).reshape(-1, 2).numpy())


@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_pack_index_map(shape):
    n_pol, n_chan, count = shape
    x = torch.as_tensor(_words(shape + (2,), 32, 12))
    got, writes = emu_pack(x.reshape(-1, 2).numpy(), n_pol, n_chan, count)
    assert (writes == 1).all()
    ref = du.dada_pack(torch.view_as_complex(x), 32).view(torch.float32).reshape(-1, 2)
    np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("shape, blocks", [((1, 1, 3), 1), ((2, 3, 5), 2), ((2, 256, 2), 7),
                                           ((1, 5, 9), 1 << 16)])
def test_lowcbf_index_map(shape, blocks):
    n_pol, n_chan, n_heaps = shape
    words = _words((n_heaps, n_chan, n_pol, 32, 2), 32, 13)
    got, writes = emu_lowcbf(words.reshape(-1, 2), n_pol, n_chan, n_heaps, blocks)
    assert (writes == 1).all()
    ref = du.lowcbf_unpack(torch.from_numpy(words.view(np.uint8).reshape(-1)), 32, *shape)
    np.testing.assert_array_equal(got, torch.view_as_real(ref).reshape(-1, 2).numpy())


def test_tile_columns():
    assert [du.tile_columns(w) for w in (1, 2, 3, 4, 5, 6, 16, 17, 32, 33, 512)] == \
        [0, 1, 2, 2, 3, 3, 4, 5, 5, 5, 5]
    # every tile holds TILE samples and its padded rows fit the kernel's
    # shared array of TILE + 32
    for w in (1, 2, 3, 512):
        tc = 1 << du.tile_columns(w)
        assert tc * (du.TILE // tc + 1) <= du.TILE + 32


# --- the wrappers ----------------------------------------------------------------

def test_wrappers_registered_and_cpu_uncounted():
    ws = kernels.wrappers()
    assert {"dada_unpack", "lowcbf_unpack", "dada_pack"} <= set(ws) and len(ws) == 11
    before = {k: ws[k].launches for k in ("dada_unpack", "lowcbf_unpack", "dada_pack")}
    raw = torch.zeros(4 * 2 * 2, dtype=torch.uint8)
    du.dada_unpack(raw, 16, 2, 1, 2)
    du.dada_pack(torch.zeros((2, 1, 2), dtype=torch.complex64), 16)
    du.lowcbf_unpack(torch.zeros(32 * 2 * 2, dtype=torch.uint8), 8, 1, 2, 1)
    assert before == {k: ws[k].launches for k in before}


def test_wrappers_check_their_operands():
    for kernel, bad in (("dada_unpack", 12), ("lowcbf_unpack", 64), ("dada_pack", 64)):
        assert not du.takes(kernel, bad) and du.takes(kernel, 16)
    with pytest.raises(ValueError, match="takes NBIT"):
        du.dada_unpack(torch.zeros(8, dtype=torch.uint8), 12, 1, 1, 1)
    with pytest.raises(ValueError, match="holds 7 bytes"):
        du.dada_unpack(torch.zeros(7, dtype=torch.uint8), 16, 1, 1, 2)
    with pytest.raises(TypeError, match="uint8"):
        du.dada_unpack(torch.zeros(2, dtype=torch.int16), 16, 1, 1, 1)
    # off the CPU and the card (a meta tensor: no data, no card)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        du.dada_unpack(torch.empty(8, dtype=torch.uint8, device="meta"), 16, 1, 1, 2)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        du.dada_pack(torch.empty((1, 1, 2), dtype=torch.complex64, device="meta"), 16)


@pytest.mark.parametrize("part", [7, 4096, 1 << 30])
def test_read_bytes_threads_and_chunks(tmp_path, monkeypatch, part):
    # reads split over threads give the file's bytes, whatever the parts
    # (odd ones, as many as there are threads, or one)
    data = np.random.default_rng(14).integers(0, 256, 50_001, dtype=np.uint8)
    path = tmp_path / "b.bin"
    data.tofile(path)
    monkeypatch.setattr(native, "PART", part)
    got = native.read_bytes(str(path), 123, 49_000, device="cpu")
    np.testing.assert_array_equal(got.numpy(), data[123:123 + 49_000])
    assert native.read_bytes(str(path), 50_001, 0, device="cpu").numel() == 0
    with pytest.raises(IOError, match="past the end"):
        native.read_bytes(str(path), 123, 49_879, device="cpu")


def test_available_only_with_a_card():
    assert native.available() is torch.cuda.is_available()


# --- on the card -----------------------------------------------------------------

CARD_SHAPES = [(1, 1, 4097), (2, 1, 1025), (2, 256, 37), (1, 3, 999), (2, 3, 1000)]


def _card_raw(words, cuda, lead=0):
    """A word buffer on the card behind ``lead`` bytes: a view whose first
    sample is no tile edge of any larger buffer."""
    b = torch.from_numpy(words.view(np.uint8).reshape(-1))
    buf = torch.zeros(lead + b.numel(), dtype=torch.uint8, device=cuda)
    buf[lead:] = b.to(cuda)
    return buf[lead:]


@pytest.mark.cuda
class TestOnCard:
    """Each kernel bitwise against its plain version on the card, at small
    shapes; the read path on the card against the CPU's; nothing falls
    back."""

    @pytest.mark.parametrize("shape", CARD_SHAPES)
    @pytest.mark.parametrize("nbit", NBITS)
    def test_unpack(self, cuda, nbit, shape):
        n_pol, n_chan, count = shape
        words = _words((count, n_chan, n_pol, 2), nbit, 20)
        raw = _card_raw(words, cuda, lead=5 * nbit // 4 * n_pol * n_chan)
        before = du.dada_unpack.launches
        got = du.dada_unpack(raw, nbit, *shape)
        assert du.dada_unpack.launches == before + 1
        ref = du.dada_unpack_core(raw, nbit, *shape)
        np.testing.assert_array_equal(_bits(got), _bits(ref))

    @pytest.mark.parametrize("shape", [(1, 1, 3), (2, 256, 5), (2, 3, 33)])
    @pytest.mark.parametrize("nbit", [8, 16, 32])
    def test_lowcbf_unpack(self, cuda, nbit, shape):
        n_pol, n_chan, n_heaps = shape
        raw = _card_raw(_words((n_heaps, n_chan, n_pol, 32, 2), nbit, 21), cuda)
        got = du.lowcbf_unpack(raw, nbit, *shape)
        np.testing.assert_array_equal(_bits(got), _bits(du.lowcbf_unpack_core(raw, nbit,
                                                                                *shape)))

    @pytest.mark.parametrize("shape", CARD_SHAPES)
    @pytest.mark.parametrize("nbit", [8, 16, 32])
    def test_pack(self, cuda, nbit, shape):
        x = _to_write(*shape, 2.0, seed=22).to(cuda)
        got = du.dada_pack(x, nbit, 2.0)
        assert torch.equal(got.cpu(), du.dada_pack_core(x, nbit, 2.0).cpu())

    def test_read_paths_on_card(self, cuda, tmp_path):
        path = _tfp_file(tmp_path, 16, 2, 3, 5000, seed=23)
        got = native.read_split(path, 4096, 2, 3, 16, 777, 3001)
        assert got.device.type == "cuda"
        ref = native.read_split(path, 4096, 2, 3, 16, 777, 3001, device="cpu")
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        lc = _lowcbf_file(tmp_path, 16, 2, 3)
        got, _ = dada.load_split(lc)
        np.testing.assert_array_equal(_bits(got), _bits(dada.load_split(lc, device="cpu")[0]))

    def test_no_fallback_on_card(self, cuda, tmp_path, monkeypatch):
        path = _tfp_file(tmp_path, 8, 2, 1, 3000, seed=24)
        ref, _ = dada.load_split(path, device="cpu")

        def boom(*args, **kwargs):
            raise AssertionError("a plain version or the numpy path ran on the card")

        for name in ("dada_unpack_core", "lowcbf_unpack_core", "dada_pack_core"):
            monkeypatch.setattr(du, name, boom)
        monkeypatch.setattr(dada, "load", boom)
        got, _ = dada.load_split(path)
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        with pytest.raises(ValueError, match="takes NBIT"):
            du.dada_unpack(torch.zeros(8, dtype=torch.uint8, device=cuda), 12, 1, 1, 1)
        with pytest.raises(ValueError, match="aligned"):
            du.dada_unpack(torch.zeros(9, dtype=torch.uint8, device=cuda)[1:], 32, 1, 1, 1)

        def no_library():
            raise RuntimeError("nvcc failed")

        monkeypatch.setattr(native._build, "library", no_library)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            dada.load_split(path)
        assert native.available() is False
