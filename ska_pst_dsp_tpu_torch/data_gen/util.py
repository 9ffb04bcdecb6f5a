"""Orchestration utilities.

The port's copy of :mod:`ska_pst_dsp_tpu.data_gen.util`: native equivalents
of the reference's python/data_gen/util.py:77-155 and the
external ``partialize`` package it depends on: subprocess helper, output
naming, dtype maps, deferred partial application, test-data caching.
"""

from __future__ import annotations

import functools
import json
import os
import shlex
import subprocess
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "updir",
    "curdir",
    "run_cmd",
    "find_existing_test_data",
    "create_output_file_names",
    "matlab_dtype_lookup",
    "partialize",
    "rpartial",
    "coro",
    "resolve_backend",
]

meta_data_file_name = "meta.json"

#: dtype → Matlab class-name strings, kept for output-name parity with the
#: reference (util.py matlab_dtype_lookup)
matlab_dtype_lookup = {
    np.float32: "single",
    np.float64: "double",
    np.complex64: "single",
    np.complex128: "double",
    np.dtype(np.float32): "single",
    np.dtype(np.float64): "double",
    np.dtype(np.complex64): "single",
    np.dtype(np.complex128): "double",
}


#: the data_gen backends: ``torch`` (the port's kernels on the card, their
#: plain versions on the CPU) and ``numpy`` (the fp64 oracle); the
#: reference's ``matlab`` and ``python`` names alias to ``numpy``
_BACKEND_ALIASES = {"torch": "torch", "numpy": "numpy", "matlab": "numpy", "python": "numpy"}


def resolve_backend(name: str) -> str:
    """``torch`` or ``numpy`` for a backend name; any other name (``jax``
    among them: this package has no JAX backend) raises ValueError."""
    try:
        return _BACKEND_ALIASES[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}: use 'torch' (the CUDA kernels) or 'numpy' "
            "(the fp64 oracle; 'matlab' and 'python' alias to it)"
        ) from None


def updir(path: str, n: int = 1) -> str:
    for _ in range(n):
        path = os.path.dirname(path)
    return path


def curdir(file: str) -> str:
    return os.path.dirname(os.path.abspath(file))


def partialize(fn):
    """Deferred partial application (the external ``partialize`` package's
    role): calling the wrapped function with keyword arguments only returns
    a configured callable; any positional argument triggers execution.

    >>> channelizer = channelize(backend="torch")     # configure
    >>> channelizer("input.dump", channels=256)     # execute
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not args:
            return functools.partial(wrapper, **kwargs)
        return fn(*args, **kwargs)

    return wrapper


def rpartial(fn, *args):
    """Partial application binding from the right (util.py rpartial)."""

    @functools.wraps(fn)
    def wrapped(*more):
        return fn(*(more + args))

    return wrapped


def coro(fn):
    """Prime a generator-based coroutine on creation (util.py coro)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        gen = fn(*args, **kwargs)
        next(gen)
        return gen

    return wrapped


def run_cmd(cmd_str: str, log_file_path: Optional[str] = None):
    """Run an external command, teeing output to a log file; non-zero exit
    raises (util.py:77-91)."""
    cmd_split = shlex.split(cmd_str)
    if log_file_path is not None:
        with open(log_file_path, "w") as log_file:
            cmd = subprocess.run(cmd_split, stdout=log_file, stderr=log_file)
    else:
        cmd = subprocess.run(cmd_split)
    if cmd.returncode != 0:
        raise RuntimeError(
            f"{cmd_split[0]} exited with status {cmd.returncode}"
            + (f" (log: {log_file_path})" if log_file_path else "")
        )
    return cmd


def create_output_file_names(
    output_file_name: Optional[str], default_base: str
) -> Tuple[str, str, str]:
    """(base, log name, output name) from an optional explicit output name
    (util.py create_output_file_names)."""
    if output_file_name is None:
        output_base = default_base
        output_file_name = output_base + ".dump"
    else:
        output_base = os.path.splitext(output_file_name)[0]
    log_file_name = output_base + ".log"
    return output_base, log_file_name, output_file_name


def find_existing_test_data(base_dir: str, domain_name: str, params):
    """Look up cached test-vector metadata in the on-disk tree
    (util.py:34-74): products persist per pipeline stage, so any stage can be
    re-run from disk — the framework's file-level checkpoint/resume."""
    arg_order = {
        "time": ("offset", "width"),
        "freq": ("frequency", "phase", "bin_offset"),
    }
    sub_dir_format_map = {
        "time": "o-{offset:.3f}_w-{width:.3f}",
        "freq": "f-{frequency:.3f}_b-{bin_offset:.3f}_p-{phase:.3f}",
    }
    if not hasattr(params, "keys"):
        params = {
            name: params[i] for i, name in enumerate(arg_order[domain_name])
        }
    sub_dir = sub_dir_format_map[domain_name].format(**params)
    sub_dir_full = os.path.join(base_dir, domain_name, sub_dir)
    if os.path.exists(sub_dir_full):
        meta_path = os.path.join(sub_dir_full, meta_data_file_name)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                return json.load(f)
    return None


class NumpyEncoder(json.JSONEncoder):
    """JSON encoder accepting numpy scalars/arrays (the external
    ``comparator.NumpyEncoder`` the reference harness uses for reports)."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, complex):
            return [obj.real, obj.imag]
        if isinstance(obj, np.complexfloating):
            return [float(obj.real), float(obj.imag)]
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)
