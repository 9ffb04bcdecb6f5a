"""The port's sharded pipelines (ska_pst_dsp_tpu_torch.parallel) on the CPU.

Each world size is one ``distributed.spawn`` of gloo ranks on the CPU
(module-scoped: world 2 runs its cases and the 2 x 1 mesh, world 4 its
cases, the 2 x 2 and 4 x 1 meshes and the larger cases), which returns
every case's per-rank outputs; ``distributed.assemble`` joins them. Each
gathered output is held

* to the port's own one-shot function on the same input, within 1e-6 x
  scale (the tolerance tests/test_sharded.py holds the JAX package to), and
* to the JAX package's sharded function on ``make_mesh(world)`` /
  ``make_mesh_2d(dc, dt)`` of the conftest's 8-device CPU mesh (under
  ``jax.jit``), on the same numpy inputs made from a seed, within 8e-6 x
  scale for analysis and 1.2e-5 x scale for inversion and round trips (the
  port's tolerances against JAX), and 1e-4 relative for the two-stage
  chains (tests/test_two_stage_sharded.py:76).

Plus: ``load_dada_sharded`` byte-equal to a full read, ``reshard`` across
uneven spans with global pads, the exchange counters, ``initialize``'s
single-process cases, the shard-size and halo checks, and a subprocess
proving that the new modules import neither jax nor the JAX package.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ska_pst_dsp_tpu.parallel import corner_turn as jct
from ska_pst_dsp_tpu.parallel import distributed as jdist
from ska_pst_dsp_tpu.parallel import sharded as jsh
from ska_pst_dsp_tpu.parallel import two_stage_sharded as jts
from ska_pst_dsp_tpu.utils.config import load_config as jax_load_config
from ska_pst_dsp_tpu_torch.io import dada
from ska_pst_dsp_tpu_torch.ops import (
    polyphase_analysis, polyphase_analysis_lowcbf, polyphase_analysis_padded,
    polyphase_synthesis,
)
from ska_pst_dsp_tpu_torch.parallel import corner_turn as ct
from ska_pst_dsp_tpu_torch.parallel import distributed as dist_
from ska_pst_dsp_tpu_torch.parallel import sharded as sh
from ska_pst_dsp_tpu_torch.parallel import two_stage_sharded as ts
from ska_pst_dsp_tpu_torch.parallel.distributed import Call, Sharded
from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.config import load_config
from ska_pst_dsp_tpu_torch.utils.rational import Rational
from test_torch_native import jax_native  # noqa: F401  (the JAX engine, loaded)

REPO = Path(__file__).resolve().parents[1]
ONE_SHOT_TOL = 1e-6
ANALYSIS_TOL = 8e-6
SYNTHESIS_TOL = 1.2e-5
TWO_STAGE_TOL = 1e-4
OS43, OS87 = "4/3", "8/7"  # strings: both packages coerce them
MESHES_2D = {2: [(2, 1)], 4: [(2, 2), (4, 1)]}
#: the reshard case: spans of a 3-sample front pad and a 7-sample tail pad
#: over uneven destinations, one of which draws on three ranks
RESHARD_N = 400
RESHARD_HAVE = [(3 + 100 * r, 103 + 100 * r) for r in range(4)]
RESHARD_WANT = [(0, 5), (5, 270), (270, 271), (271, 410)]


def _filt(taps, block):
    n = np.arange(taps) - (taps - 1) / 2
    h = np.sinc(n / block) * np.hamming(taps)
    return (h / h.sum()).astype(np.float64)


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


F32, F56, F16 = _filt(257, 32), _filt(449, 56), _filt(129, 16)
SYN_KW = dict(input_overlap=8, deripple_coeff=F16, temporal_taper="tukey")
#: per case of the basic set: (the port's sharded function, args after x,
#: kwargs); the JAX function has the same name and order
BASIC = {
    "analysis": ("ana", "sharded_polyphase_analysis", (F32, 32, OS43), {}),
    "padded": ("pad", "sharded_polyphase_analysis_padded", (F56, 56, OS87), {}),
    "synthesis": ("syn", "sharded_polyphase_synthesis", (64, OS43), SYN_KW),
    "synthesis_combine": ("syn", "sharded_polyphase_synthesis", (64, OS43),
                          dict(SYN_KW, combine=4)),
    "round_trip": ("rt", "sharded_round_trip", (F32, 32, OS43, 64, 12), {}),
    "round_trip_padded": ("rtp", "sharded_round_trip_padded", (F56, 56, OS87, 112, 8), {}),
}
MESH_CASES = {
    "analysis_2d": ("ana", "sharded_polyphase_analysis_2d", (F32, 32, OS43), {}, "chan_time"),
    "synthesis_2d": ("syn", "sharded_polyphase_synthesis_2d", (64, OS43), SYN_KW, "time_chan"),
    "round_trip_2d": ("rt", "sharded_round_trip_2d", (F32, 32, OS43, 64, 12), {}, "time_chan"),
}
MID = (4096, OS87, 512, 128)
MID_TAPS = 2 * 4096 + 1


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The cases' global inputs, made from seeds, and their .npy paths
    (each rank maps its own piece)."""
    d = tmp_path_factory.mktemp("parallel")
    arrays = {
        "ana": _noise((2, 4 * 24 * 4 * 40), 1),
        "pad": _noise((1, 4 * 49 * 8 * 10), 2),
        "syn": _noise((2, 16, 4 * 48 * 6), 3),
        "rt": _noise((2, 4 * 24 * 4 * 64), 4),
        "rtp": _noise((1, 4 * 49 * 8 * 40), 5),
        "mid": _noise((1, 1024 * 3584), 7),
        "lowcbf": _noise((2, 4 * 768 * 20 + 1000), 8),
        "low_low": _noise((1, (10_200_000 // 3072 + 1) * 3072), 11),
        "sps": _noise((1, (1_500_000 // 27648 + 1) * 27648), 12),
        "reshard": np.arange(RESHARD_N, dtype=np.float32).astype(np.complex64)[None],
    }
    paths = {}
    for k, a in arrays.items():
        paths[k] = str(d / f"{k}.npy")
        np.save(paths[k], a)
    raw = _noise((2, 1, 4 * 192 * 4 * 100 + 37), 9)
    paths["dada"] = str(d / "raw.dada")
    dada.save(paths["dada"], raw, {"NPOL": "2", "NCHAN": "1", "NBIT": "32", "NDIM": "2",
                                   "TSAMP": "0.08", "HDR_SIZE": "4096"})
    arrays["dada"] = raw
    return arrays, paths


def _calls(world, paths):
    """(name, Call, layout, dc) of every case a world's spawn runs."""
    out = []
    for name, (key, fn, args, kw) in BASIC.items():
        out.append((name, Call(getattr(sh, fn), (Sharded(paths[key]), *args), kw), "time", 1))
    for dc, dt in MESHES_2D[world]:
        for name, (key, fn, args, kw, layout) in MESH_CASES.items():
            x = Sharded(paths[key], "chan_time" if key == "syn" else "time")
            out.append((f"{name}_{dc}x{dt}", Call(getattr(ct, fn), (x, *args), kw,
                                                  mesh_2d=(dc, dt)), layout, dc))
    if world == 4:
        low, sps, lowpsi = load_config("low"), load_config("sps"), load_config("lowpsi")
        out += [
            ("mid_2d", Call(ct.sharded_round_trip_2d_padded,
                            (Sharded(paths["mid"]), _filt(MID_TAPS, 4096), *MID),
                            mesh_2d=(2, 2)), "time_chan", 2),
            ("lowcbf", Call(ts.sharded_lowcbf_analysis,
                            (Sharded(paths["lowcbf"]), lowpsi.load_fir_filter_coeff())),
             "time", 1),
            ("low_low", Call(ts.sharded_two_stage_round_trip,
                             (Sharded(paths["low_low"]), low, low),
                             dict(critical=True, combine=16)), "time", 1),
            ("sps_lowpsi", Call(ts.sharded_two_stage_round_trip,
                                (Sharded(paths["sps"]), sps, lowpsi),
                                dict(critical=True, invert=False)), "time", 1),
            ("load_dada", Call(dist_.load_dada_sharded, (paths["dada"],)), "time", 1),
            ("file_round_trip", Call(dist_.sharded_file_round_trip, (paths["dada"], low)),
             "time", 1),
            ("reshard", Call(sh.reshard, (Sharded(paths["reshard"]), RESHARD_HAVE,
                                          RESHARD_WANT)), "time", 1),
        ]
    return out


@pytest.fixture(scope="module")
def spawned(inputs):
    """world -> {case: (gathered output, per-rank results)}: one spawn per
    world size, run on first use."""
    _, paths = inputs

    @functools.lru_cache(maxsize=None)
    def run(world):
        cases = _calls(world, paths)
        ranks = dist_.spawn(dist_.run_calls, world, device="cpu",
                            timeout=400, args=([c for _, c, _, _ in cases],))
        got = {}
        for i, (name, _, layout, dc) in enumerate(cases):
            pieces = [r[i]["out"] for r in ranks]
            if name == "load_dada":
                pieces = [p[0] for p in pieces]
            got[name] = (dist_.assemble(pieces, layout, dc), [r[i] for r in ranks])
        return got

    return run


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, ref, tol, n=None):
    """max |got - ref| <= tol * max |ref| over the first n samples of the
    last axis (all where n is None; shapes equal then)."""
    got, ref = _np(got), _np(ref)
    if n is None:
        assert got.shape == ref.shape, (got.shape, ref.shape)
    else:
        assert got.shape[:-1] == ref.shape[:-1] and n > 0
        got, ref = got[..., :n], ref[..., :n]
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max|err|/scale {err:.3g} > {tol}"


def _jax(fn, x, *args, **kw):
    """A JAX sharded function under jax.jit on (re, im) float32 input;
    complex numpy out."""
    xr = np.ascontiguousarray(x.real).astype(np.float32)
    xi = np.ascontiguousarray(x.imag).astype(np.float32)
    rr, ri = jax.jit(lambda a, b: fn((a, b), *args, **kw))(xr, xi)
    return np.asarray(rr) + 1j * np.asarray(ri)


def _one_shot(key, x, combine=1):
    """The port's one-shot chain of a case's input."""
    x = torch.as_tensor(x)
    if key == "ana":
        return polyphase_analysis(x, F32, 32, OS43)
    if key == "pad":
        return polyphase_analysis_padded(x, F56, 56, OS87)
    if key == "syn":
        return polyphase_synthesis(x, 64, OS43, combine=combine, **SYN_KW)
    if key == "rt":
        return polyphase_synthesis(polyphase_analysis(x, F32, 32, OS43), 64, OS43,
                                   input_overlap=12, deripple_coeff=F32, temporal_taper="tukey")
    if key == "rtp":
        return polyphase_synthesis(polyphase_analysis_padded(x, F56, 56, OS87), 112, OS87,
                                   input_overlap=8, deripple_coeff=F56, temporal_taper="tukey")
    if key == "mid":
        f = _filt(MID_TAPS, 4096)
        return polyphase_synthesis(polyphase_analysis_padded(x, f, 4096, OS87), 512, OS87,
                                   input_overlap=128, deripple_coeff=f, temporal_taper="tukey")
    raise KeyError(key)


#: per round-trip key: (taps, channels, os, L, overlap, padded analysis)
ROUND_TRIPS = {"rt": (F32.size, 32, OS43, 64, 12, False),
               "rtp": (F56.size, 56, OS87, 112, 8, True),
               "mid": (MID_TAPS, *MID, True),
               "file": (None, 256, OS43, 256, 48, False)}


def _sharded_len(key, n_dat, one_len, dt, dc=1):
    """Samples along the last axis of a gathered sharded output of an
    n_dat-sample input on dt time ranks (dc channel ranks). An analysis
    gives n_dat // step spectra (the last rank's tail past the one-shot
    count comes from the zero halo); the inversion the one-shot count; a
    round trip the one-shot count of its fine channels cut to whole
    blocks per time shard, a multiple of dc of them."""
    if key in ("ana", "pad"):
        block, os_f = (32, OS43) if key == "ana" else (56, OS87)
        return n_dat // geometry.analysis_step(block, Rational.coerce(os_f))
    if key not in ROUND_TRIPS:
        return one_len
    taps, n_chan, os_f, L, ov, padded = ROUND_TRIPS[key]
    os_f = Rational.coerce(os_f)
    step = geometry.analysis_step(n_chan, os_f)
    if key == "file":  # the file's stream, cut to the 1-D sharding quantum
        taps = load_config("low").load_fir_filter_coeff().size
        n_dat = n_dat // (dt * step * os_f.nu) * (dt * step * os_f.nu)
    t_valid = (n_dat // step if padded
               else geometry.analysis_nblocks(n_dat, taps, n_chan, os_f))
    geom = geometry.SynthesisGeometry(n_chan, L, ov, os_f)
    quantum = dt * geom.input_keep * dc
    return geom.n_blocks(t_valid // quantum * quantum) * geom.output_keep


def _vs_one_shot(got, one, n):
    """The gathered sharded output holds exactly n samples along its last
    axis (_sharded_len) and equals the one-shot chain wherever both have
    samples."""
    assert got.shape[-1] == n > 0, (tuple(got.shape), n)
    _close(got, one, ONE_SHOT_TOL, min(n, one.shape[-1]))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(BASIC))
def test_sharded_1d(spawned, inputs, world, name):
    """1-D analysis, padded analysis, synthesis with and without combine,
    the low-style and mid-style round trips: the gathered output equals
    the one-shot chain and the JAX sharded function."""
    arrays, _ = inputs
    got, _ = spawned(world)[name]
    key, fn, args, kw = BASIC[name]
    one = _one_shot(key, arrays[key], kw.get("combine", 1))
    _vs_one_shot(got, one, _sharded_len(key, arrays[key].shape[-1], one.shape[-1], world))
    ref = _jax(getattr(jsh, fn), arrays[key], *args, jsh.make_mesh(world), **kw)
    _close(got, ref, ANALYSIS_TOL if key in ("ana", "pad") else SYNTHESIS_TOL)


@pytest.mark.parametrize("world, dc, dt", [(w, dc, dt) for w in (2, 4) for dc, dt in MESHES_2D[w]])
@pytest.mark.parametrize("name", list(MESH_CASES))
def test_sharded_2d(spawned, inputs, name, world, dc, dt):
    """The ('chan', 'time') analysis, corner-turn synthesis and round trip
    on the 2 x 1, 2 x 2 and 4 x 1 meshes: equal to the one-shot chain and
    to the JAX 2-D functions on make_mesh_2d(dc, dt)."""
    arrays, _ = inputs
    got, ranks = spawned(world)[f"{name}_{dc}x{dt}"]
    key, fn, args, kw, _ = MESH_CASES[name]
    one = _one_shot(key, arrays[key])
    _vs_one_shot(got, one, _sharded_len(key, arrays[key].shape[-1], one.shape[-1], dt, dc))
    ref = _jax(getattr(jct, fn), arrays[key], *args, jct.make_mesh_2d(dc, dt), **kw)
    _close(got, ref, ANALYSIS_TOL if key == "ana" else SYNTHESIS_TOL)
    if key != "ana" and dc > 1:  # the corner turn: one all-to-all a rank
        assert all(r["exchanges"]["all_to_all"]["calls"] == 1 for r in ranks)


def test_mid_chain_2d(spawned, inputs):
    """The reduced-tap SKA-Mid 2-D chain of tests/test_sharded.py::
    TestMidGeometry2D (4096 channels, 2 taps per channel, the
    1,835,008-point inversion block) on the 2 x 2 mesh."""
    arrays, _ = inputs
    got, _ = spawned(4)["mid_2d"]
    one = _one_shot("mid", arrays["mid"])
    _vs_one_shot(got, one, _sharded_len("mid", arrays["mid"].shape[-1], one.shape[-1], 2, 2))
    ref = _jax(jct.sharded_round_trip_2d_padded, arrays["mid"], _filt(MID_TAPS, 4096), *MID,
               jct.make_mesh_2d(2, 2))
    _close(got, ref, SYNTHESIS_TOL)


def test_lowcbf(spawned, inputs):
    """The sharded LowCBF filterbank (global first-call and alignment
    pads, 4*STEP-aligned shards): equal to the one-shot firmware model and
    to the JAX sharded function."""
    arrays, _ = inputs
    got, _ = spawned(4)["lowcbf"]
    x = arrays["lowcbf"]
    one = polyphase_analysis_lowcbf(torch.as_tensor(x), load_config("lowpsi").load_fir_filter_coeff())
    _close(got, one, ONE_SHOT_TOL)
    ref = _jax(jts.sharded_lowcbf_analysis, x, jax_load_config("lowpsi").load_fir_filter_coeff(),
               jsh.make_mesh(4))
    _close(got, ref, ANALYSIS_TOL)


@pytest.mark.parametrize("name, cfgs, kw", [
    ("low_low", ("low", "low"), dict(critical=True, combine=16, invert=True)),
    ("sps_lowpsi", ("sps", "lowpsi"), dict(critical=True, combine=1, invert=False)),
])
def test_two_stage(spawned, inputs, name, cfgs, kw):
    """Low x low critical with combine 16 (10.2 Msamples: one combined
    inversion block) and sps -> lowpsi: within 1e-4 relative of the JAX
    sharded chain on make_mesh(4)."""
    arrays, _ = inputs
    got, ranks = spawned(4)[name]
    ref = _jax(jts.sharded_two_stage_round_trip, arrays[name if name == "low_low" else "sps"],
               *(jax_load_config(c) for c in cfgs), jsh.make_mesh(4), **kw)
    assert got.shape[:2] == ref.shape[:2] and got.shape[-1] > 0
    _close(got, ref, TWO_STAGE_TOL, min(got.shape[-1], ref.shape[-1]))
    assert got.shape[-1] == ref.shape[-1]


def test_load_dada_sharded(spawned, inputs):
    """Each rank reads its own time shard; together they are the full
    read's first 4 * (n // 4) samples, byte for byte."""
    arrays, paths = inputs
    got, _ = spawned(4)["load_dada"]
    full, _ = dada.load(paths["dada"])
    n = (full.shape[-1] // 4) * 4
    np.testing.assert_array_equal(got.numpy(), full[:, 0, :n])


def test_sharded_file_round_trip(spawned, inputs, jax_native):
    """DADA file -> per-rank ingest -> sharded round trip: equal to the
    one-shot chain on the file's stream, and to the JAX package's
    sharded_file_round_trip (which reads through its native engine)."""
    arrays, paths = inputs
    got, _ = spawned(4)["file_round_trip"]
    cfg = load_config("low")
    filt = cfg.load_fir_filter_coeff()
    x = torch.as_tensor(arrays["dada"][:, 0])
    one = polyphase_synthesis(polyphase_analysis(x, filt, cfg.channels, cfg.os_factor),
                              cfg.input_fft_length, cfg.os_factor,
                              input_overlap=cfg.input_overlap, deripple_coeff=filt,
                              temporal_taper=cfg.temporal_taper)
    _vs_one_shot(got, one, _sharded_len("file", x.shape[-1], one.shape[-1], 4))
    rr, ri = jdist.sharded_file_round_trip(paths["dada"], jax_load_config("low"),
                                           jsh.make_mesh(4))
    _close(got, np.asarray(rr) + 1j * np.asarray(ri), SYNTHESIS_TOL)


def test_reshard_uneven(spawned):
    """reshard from even spans shifted by a 3-sample front pad to uneven
    spans with a 7-sample tail pad: every rank holds exactly its wanted
    global samples, zeros where none was, and one destination drew on
    three ranks."""
    got, ranks = spawned(4)["reshard"]
    x = np.arange(RESHARD_N, dtype=np.float32)
    padded = np.concatenate([np.zeros(3), x, np.zeros(7)]).astype(np.complex64)
    np.testing.assert_array_equal(got.numpy()[0], padded)
    assert [r["out"].shape[-1] for r in ranks] == [b - a for a, b in RESHARD_WANT]
    assert all(r["exchanges"]["reshard"]["calls"] == 1 for r in ranks)


def test_exchange_counters(spawned):
    """The mesh counts what each exchange moved: the analysis halo is
    padded_taps complex samples per polarization sent by every rank but
    the first; nothing is staged on the CPU."""
    for world in (2, 4):
        _, ranks = spawned(world)["analysis"]
        halo = [r["exchanges"]["halo"] for r in ranks]
        assert [h["bytes"] for h in halo] == [0] + [2 * 288 * 8] * (world - 1)
        assert all(h["calls"] == 1 and h["staged_bytes"] == 0 for h in halo)
        assert all(r["backend"] == "gloo" and not r["staged"] for r in ranks)
        assert all(v == 0 for r in ranks for v in r["launches"].values())


def test_halo_longer_than_shard_raises():
    """A halo comes from one neighbour: on one rank the circular halo (the
    group-delay roll) cannot take more than the shard."""
    mesh = sh.make_mesh(device="cpu")
    x = torch.zeros((1, 10), dtype=torch.complex64)
    assert torch.equal(sh.right_halo(x, 20, mesh), torch.zeros((1, 20), dtype=torch.complex64))
    with pytest.raises(ValueError, match="one neighbour"):
        sh.right_halo(x, 20, mesh, circular=True)


def test_shard_not_a_multiple_raises():
    """A shard that is not a multiple of step*nu (analysis) or input_keep
    (inversion) raises, as in the JAX package."""
    mesh = sh.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="multiple of step\\*nu = 96"):
        sh.sharded_polyphase_analysis(_noise((1, 96 * 10 + 24), 0), F32, 32, OS43, mesh)
    with pytest.raises(ValueError, match="multiple of step\\*nu"):
        sh.sharded_polyphase_analysis_padded(_noise((1, 392 * 3 + 49), 0), F56, 56, OS87, mesh)
    with pytest.raises(ValueError, match="input_keep=48"):
        sh.sharded_polyphase_synthesis(_noise((1, 16, 48 * 3 + 8), 0), 64, OS43, mesh,
                                       input_overlap=8)


def test_one_rank_mesh_is_the_one_shot_chain():
    """Without a process group the mesh is one rank and the sharded round
    trip is the one-shot chain (no halo, no exchange)."""
    mesh = sh.make_mesh(device="cpu")
    assert (mesh.world, mesh.backend, mesh.time_group) == (1, None, None)
    x = _noise((2, 4 * 24 * 4 * 64), 4)
    got = sh.sharded_round_trip(x, F32, 32, OS43, 64, 12, mesh)
    one = _one_shot("rt", x)
    _vs_one_shot(got, one, _sharded_len("rt", x.shape[-1], one.shape[-1], 1))
    assert all(v["calls"] == 0 for v in mesh.stats().values())
    with pytest.raises(ValueError, match="process group of 4"):
        sh.make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        ct.make_mesh_2d(2, 2, device="cpu")


class TestInitialize:
    ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

    def test_single_process_noop(self, monkeypatch):
        for k in self.ENV:
            monkeypatch.delenv(k, raising=False)
        assert dist_.initialize() is False

    @pytest.mark.parametrize("env", [
        {"WORLD_SIZE": "4", "RANK": "1"},  # no address
        {"MASTER_ADDR": "localhost", "MASTER_PORT": "29500", "WORLD_SIZE": "1", "RANK": "0"},
        {"MASTER_ADDR": "localhost", "MASTER_PORT": "29500", "WORLD_SIZE": "4"},  # no rank
    ])
    def test_incomplete_cluster_env(self, monkeypatch, env):
        for k in self.ENV:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert dist_.initialize() is False


def test_default_backend():
    """NCCL only where every rank has a card of its own; never a fallback."""
    assert dist_.default_backend(4, "cpu") == "gloo"
    assert dist_.default_backend(1, "cpu") == "gloo"
    want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    assert dist_.default_backend(2, "cuda") == want


def test_spawn_reports_a_failing_rank():
    """A rank that raises stops the run: the others are killed and the
    caller gets the rank's traceback."""
    with pytest.raises(RuntimeError, match="rank [01] exited"):
        dist_.spawn(sh.reshard, 2, device="cpu", timeout=60,
                    args=(None, [(0, 1)], [(0, 1)]))


def test_parallel_imports_no_jax():
    """Importing the new modules and running one single-process round trip
    leaves jax and every module of the JAX package out of sys.modules."""
    mods = ["parallel", "parallel.sharded", "parallel.corner_turn",
            "parallel.two_stage_sharded", "parallel.distributed", "cli.scaling_bench",
            "analysis.param_opt", "entry"]
    code = ("import sys, json, torch\n"
            + "".join(f"import ska_pst_dsp_tpu_torch.{m}\n" for m in mods)
            + "from ska_pst_dsp_tpu_torch.parallel import sharded\n"
            "from ska_pst_dsp_tpu_torch.design import fir\n"
            "f = fir.design_pfb_fir_filter(32, '4/3', 8)\n"
            "m = sharded.make_mesh(device='cpu')\n"
            "x = torch.randn(1, 24576, dtype=torch.complex64)\n"
            "out = sharded.sharded_round_trip(x, f, 32, '4/3', 64, 12, m)\n"
            "def named(p): return sorted(k for k in sys.modules if k == p or k.startswith(p + '.'))\n"
            "print(json.dumps({'jax': named('jax'), 'pkg': named('ska_pst_dsp_tpu'),"
            " 'shape': list(out.shape)}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["jax"] == [] and got["pkg"] == [] and got["shape"][:2] == [1, 1]
