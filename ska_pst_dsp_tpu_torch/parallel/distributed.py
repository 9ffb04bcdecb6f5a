"""Process-group set-up, per-rank DADA ingest, and local multi-process
runs.

Counterpart of :mod:`ska_pst_dsp_tpu.parallel.distributed`:

* :func:`initialize` joins a ``torch.distributed`` process group from
  explicit arguments or the ``torchrun`` environment (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); one process is a no-op.
* :func:`load_dada_sharded` has each rank read only its own byte range of a
  DADA file; :func:`sharded_file_round_trip` runs the time-sharded round
  trip on it.
* :func:`spawn` runs ``fn(mesh, *args)`` on every rank of a local process
  group (one process per rank, a ``file://`` rendezvous in a temporary
  directory, a hard timeout) and returns each rank's result, with the
  kernels' launch counts and the mesh's exchange counters where the rank
  body is :func:`run_calls`, which applies a list of :class:`Call`
  objects to shards of global inputs (:class:`Sharded`); :func:`assemble`
  joins the ranks' outputs back into the global array.

The backend is chosen, never tried: :func:`default_backend` gives NCCL
where every rank has a card of its own and gloo otherwise (ranks sharing a
card, or the CPU). :func:`spawn` takes it from the world and device;
:func:`initialize` (a cluster launched by ``torchrun``) takes it as an
argument.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, ContextManager, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ska_pst_dsp_tpu_torch.utils import geometry
from ska_pst_dsp_tpu_torch.utils.profiling import clock
from ska_pst_dsp_tpu_torch.utils.rational import Rational

from ..io import dada
from .sharded import Mesh, even_spans, make_mesh, reshard, sharded_round_trip

module_logger = logging.getLogger(__name__)


def default_backend(world: int, device="cuda") -> str:
    """NCCL where each of ``world`` ranks has a card of its own, else gloo
    (ranks sharing a card: NCCL refuses two ranks on one device; or the
    CPU)."""
    if torch.device(device).type != "cuda" or torch.cuda.device_count() < world:
        return "gloo"
    return "nccl"


#: seconds a collective may wait before the process group gives up
GROUP_TIMEOUT = 600.0


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, backend: Optional[str] = None) -> bool:
    """Join the process group if one is configured; a no-op otherwise.

    Explicit arguments override the ``torchrun`` environment
    (``MASTER_ADDR``/``MASTER_PORT`` give ``tcp://addr:port``,
    ``WORLD_SIZE``, ``RANK``). With no address or a world of one this is
    single-process mode and returns False; otherwise it calls
    ``init_process_group`` with ``backend`` (default
    :func:`default_backend` for the world on the card) and returns True."""
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "0")) or None
    if rank is None and env.get("RANK") is not None:
        rank = int(env["RANK"])
    if not init_method or not world_size or world_size <= 1 or rank is None:
        module_logger.debug("single-process mode (no process group configured)")
        return False
    backend = backend or default_backend(world_size)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    module_logger.info("joined process group: rank %d of %d (%s)", rank, world_size, backend)
    return True


def _samples(path: str, header: Dict[str, str]) -> int:
    """Time samples in a DADA file, from its size."""
    n_chan = int(header.get("NCHAN", 1))
    npol = int(header.get("NPOL", 1))
    ndim = int(header.get("NDIM", 2))
    nbit = int(header.get("NBIT", 32))
    hdr_size = int(header.get("HDR_SIZE", dada.DEFAULT_HDR_SIZE))
    return (os.path.getsize(path) - hdr_size) // (npol * n_chan * ndim * (nbit // 8))


def load_dada_sharded(path: str, mesh: Mesh, count: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Dict[str, str]]:
    """Read rank (c, t)'s time shard t of a DADA file, touching only its
    own byte range: the ingest engine (``io.dada.load_split`` with
    ``offset_samples``) reads it to the rank's device and unpacks it there.

    The stream (the first ``count`` samples, where given) is cut to a
    multiple of the time-group size (of 32-sample heaps for a LowCBF file)
    and split evenly. Returns ((n_pol, n_local) complex64 for a raw stream,
    (n_pol, n_chan, n_local) for fine channels, on the rank's device; the
    header)."""
    header = dada.read_header(path)
    total = _samples(path, header)
    if count is not None:
        total = min(total, count)
    unit = mesh.dt * (dada.NSAMP_PER_HEAP if header.get("INSTRUMENT") == "LowCBF" else 1)
    per_shard = (total // unit) * unit // mesh.dt
    local, header = dada.load_split(path, count=per_shard, offset_samples=mesh.t * per_shard,
                                    device=mesh.device)
    return (local[:, 0] if local.shape[1] == 1 else local), header


def sharded_file_round_trip(path: str, config, mesh: Mesh, *, count: Optional[int] = None
                            ) -> torch.Tensor:
    """DADA file -> per-rank ingest -> time-sharded analysis and Golden
    inversion. The stream is cut to a multiple of the sharding quantum
    (``reshard``); returns the rank's slice of the global inversion."""
    local, _ = load_dada_sharded(path, mesh, count=count)
    filt = config.load_fir_filter_coeff()
    os_f = Rational.coerce(config.os_factor)
    step = geometry.analysis_step(config.channels, os_f)
    quantum = mesh.dt * step * os_f.nu
    n_local = local.shape[-1]
    n_dat = (n_local * mesh.dt // quantum) * quantum
    local = reshard(local, even_spans(n_local, mesh.dt), even_spans(n_dat // mesh.dt, mesh.dt),
                    mesh)
    return sharded_round_trip(local, filt, config.channels, os_f, config.input_fft_length,
                              config.input_overlap, mesh, temporal_taper=config.temporal_taper,
                              deripple=bool(config.deripple))


# --- local multi-process runs -----------------------------------------------

#: layouts of a global array over a mesh, as the JAX package's PartitionSpecs
LAYOUTS = ("time", "chan_time", "time_chan")


@dataclasses.dataclass
class Sharded:
    """A global array for a :class:`Call`, of which each rank takes its own
    piece: ``layout`` "time" (the last axis split over the time group,
    ``P(None, 'time')``) or "chan_time" (axis -2 over the channel group as
    well, ``P(None, 'chan', 'time')``). ``data`` is a numpy array or the
    path of a ``.npy`` file, which each rank maps and reads its piece of."""
    data: Union[np.ndarray, str]
    layout: str = "time"

    def piece(self, mesh: Mesh) -> torch.Tensor:
        a = np.load(self.data, mmap_mode="r") if isinstance(self.data, str) else self.data
        n = a.shape[-1]
        if n % mesh.dt:
            raise ValueError(f"{n} samples do not split over {mesh.dt} time ranks")
        t = slice(mesh.t * (n // mesh.dt), (mesh.t + 1) * (n // mesh.dt))
        if self.layout == "time":
            a = a[..., t]
        elif self.layout == "chan_time":
            cs = a.shape[-2] // mesh.dc
            a = a[..., mesh.c * cs:(mesh.c + 1) * cs, t]
        else:
            raise ValueError(f"an input layout is 'time' or 'chan_time', not {self.layout!r}")
        return torch.from_numpy(np.array(a)).to(mesh.device)


@dataclasses.dataclass
class Call:
    """``fn(*args, mesh=mesh, **kwargs)`` on every rank, each
    :class:`Sharded` argument replaced by the rank's piece; ``mesh`` the
    spawn's time mesh or, with ``mesh_2d = (dc, dt)``, a ('chan', 'time')
    mesh. ``runs`` times it is run (each timed; the last one's output and
    counts are kept). ``fn`` must be importable by name (a module-level
    function)."""
    fn: Callable
    args: tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    mesh_2d: Optional[Tuple[int, int]] = None
    runs: int = 1


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_cpu(o) for o in obj)
    return obj


def run_calls(mesh: Mesh, calls: Sequence[Call],
              guard: Optional[Callable[[], ContextManager]] = None) -> List[Dict[str, Any]]:
    """A rank body for :func:`spawn`: every call in order, its runs each
    from the kernels' launch counts and the mesh's exchange counters set to
    0, inside ``guard()`` where given (a context the caller uses to make
    the plain versions raise, say). Returns, per call, of its last run,
    ``{"out": output on the CPU, "launches": {kernel: n},
    "composed_epilogues": n, "exchanges": Mesh.stats(), "ms": [per run],
    "exchange_ms", "compute_ms"}`` (compute = the last run less its
    exchanges)."""
    from ..ops.kernels import wrappers as kernel_wrappers
    from ..ops.kernels.synthesis_fused import fused_inversion as inversion

    wrappers = kernel_wrappers()
    meshes = {None: mesh}
    results = []
    for call in calls:
        if call.mesh_2d not in meshes:
            from .corner_turn import make_mesh_2d

            meshes[call.mesh_2d] = make_mesh_2d(*call.mesh_2d, device=mesh.device)
        m = meshes[call.mesh_2d]
        args = [a.piece(m) if isinstance(a, Sharded) else a for a in call.args]
        kwargs = {k: v.piece(m) if isinstance(v, Sharded) else v for k, v in call.kwargs.items()}
        times = []
        for _ in range(call.runs):
            for w in wrappers.values():
                w.launches = 0
            inversion.composed_epilogues = 0
            m.reset()
            with guard() if guard is not None else contextlib.nullcontext():
                if m.device.type == "cuda":
                    torch.cuda.synchronize(m.device)
                stop = clock(m.device)
                out = call.fn(*args, mesh=m, **kwargs)
                times.append(stop())
        stats = m.stats()
        exchange_ms = sum(s["ms"] for s in stats.values())
        results.append({
            "out": _to_cpu(out), "launches": {k: w.launches for k, w in wrappers.items()},
            "composed_epilogues": inversion.composed_epilogues, "exchanges": stats,
            "ms": times, "exchange_ms": exchange_ms, "compute_ms": times[-1] - exchange_ms,
            "backend": m.backend, "staged": m.staged,
        })
    return results


def assemble(pieces: Sequence[torch.Tensor], layout: str, dc: int = 1) -> torch.Tensor:
    """The global array from each rank's piece (in rank order) of a mesh of
    ``dc`` channel ranks: "time" joins the pieces of the ranks with c = 0
    along the last axis in order of t; "chan_time" joins channel slices
    along axis -2, then time shards; "time_chan" joins output chunk
    ``t * dc + c`` in chunk order."""
    dt = len(pieces) // dc
    rank = [[pieces[c * dt + t] for t in range(dt)] for c in range(dc)]
    if layout == "time":
        return torch.cat(rank[0], dim=-1)
    if layout == "chan_time":
        return torch.cat([torch.cat([rank[c][t] for c in range(dc)], dim=-2)
                          for t in range(dt)], dim=-1)
    if layout == "time_chan":
        return torch.cat([rank[c][t] for t in range(dt) for c in range(dc)], dim=-1)
    raise ValueError(f"layout is one of {LAYOUTS}, not {layout!r}")


def _rank_main(rank: int, world: int, backend: str, device: str, tmp: str,
               timeout: float) -> None:
    """One spawned rank: load the function and its arguments, join the
    group through the file rendezvous, build the time mesh, run the
    function, save its result (or the traceback) in tmp."""
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        result = fn(make_mesh(world, device=dev), *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, device: str = "cuda", timeout: float = 600.0,
          args: tuple = ()) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world`` new processes joined in one
    process group over a ``file://`` rendezvous in a temporary directory
    (no port to collide on), each with the time mesh over the group on its
    device (``cuda:(rank % device_count)``, or the CPU). The backend is
    :func:`default_backend` of the world and device (the mesh's
    ``backend``, which :func:`run_calls` reports). ``fn`` must be
    importable by name: a module-level function of the package or of the
    main script. Returns each rank's result in rank order. A rank that
    fails, or a run longer than ``timeout`` seconds, kills every rank and
    raises."""
    backend = default_backend(world, device)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ska_pst_spawn_") as tmp:
        # through a file, not the process pipe: a start() whose arguments
        # outgrow the pipe waits for its child to boot, one rank at a time
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, backend, device, tmp, timeout))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if not p.is_alive() and p.exitcode != 0]
                if failed:
                    raise RuntimeError(_failure(tmp, failed[0], procs[failed[0]].exitcode))
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks ran past {timeout} s")
                time.sleep(0.05)
            for r, p in enumerate(procs):
                if p.exitcode != 0:
                    raise RuntimeError(_failure(tmp, r, p.exitcode))
            return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                    for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)


def _failure(tmp: str, rank: int, exitcode) -> str:
    path = os.path.join(tmp, f"rank{rank}.err")
    detail = open(path).read() if os.path.exists(path) else "no traceback"
    return f"rank {rank} exited with {exitcode}:\n{detail}"
