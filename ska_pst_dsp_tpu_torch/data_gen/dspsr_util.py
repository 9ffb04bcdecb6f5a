"""dspsr / psrchive tool wrappers.

The port's copy of :mod:`ska_pst_dsp_tpu.data_gen.dspsr_util`, the
equivalent of python/data_gen/dspsr_util.py:1-409: singleton runner classes
driving the external C++ pulsar tools (``dspsr``, ``psrdiff``, ``psrtxt``)
via subprocess, plus log/psrtxt parsers. The binaries are optional;
when absent the runners raise a clear ToolUnavailable so
harnesses can fall back to the framework's native implementations (the
Golden inversion kernel fills dspsr's InverseFilterbank role, and
ops/dedispersion fills its coherent-dedispersion role).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import typing

import numpy as np

from . import util

__all__ = [
    "ToolUnavailable",
    "BaseRunner",
    "DspsrRunner",
    "DspsrDumpRunner",
    "PsrdiffRunner",
    "PsrtxtRunner",
    "run_dspsr",
    "run_dspsr_with_dump",
    "run_psrdiff",
    "run_psrtxt",
    "load_psrtxt_data",
    "find_in_log",
]

module_logger = logging.getLogger(__name__)


class ToolUnavailable(RuntimeError):
    def __init__(self, tool: str):
        super().__init__(
            f"external tool {tool!r} is not on PATH; use the framework's "
            f"native backends (ops.polyphase_synthesis / ops.dedispersion) "
            f"instead"
        )
        self.tool = tool


class BaseRunner:
    """Subprocess runner with output-dir management and chaining
    (dspsr_util.py:89-104)."""

    tool: str = ""

    def __init__(self, output_dir: str = "./"):
        self.output_dir = output_dir

    def check_available(self):
        if shutil.which(self.tool) is None:
            raise ToolUnavailable(self.tool)

    @classmethod
    def chain(cls, *runners):
        """Compose runners left-to-right over a file argument."""

        def chained(file_path, **kwargs):
            result = file_path
            for runner in runners:
                result = runner(result, **kwargs)
            return result

        return chained


class DspsrRunner(BaseRunner):
    """``dspsr -c P -D DM <file> -O <out>`` (dspsr_util.py:107-189)."""

    tool = "dspsr"

    def __call__(
        self,
        file_path: str,
        period: float = None,
        dm: float = None,
        output_file_name: str = None,
        extra_args: str = "",
        **kwargs,
    ):
        self.check_available()
        base = os.path.splitext(os.path.basename(file_path))[0]
        output_file_name = output_file_name or base
        out_base = os.path.join(self.output_dir, output_file_name)
        cmd = f"{self.tool} "
        if period is not None:
            cmd += f"-c {period} "
        if dm is not None:
            cmd += f"-D {dm} "
        cmd += f"{file_path} -O {out_base} {extra_args}"
        log_path = out_base + ".log"
        module_logger.debug("DspsrRunner: %s", cmd)
        util.run_cmd(cmd, log_file_path=log_path)
        return out_base + ".ar", log_path


class DspsrDumpRunner(DspsrRunner):
    """dspsr with ``-dump <Stage>``; renames the produced pre_<Stage>.dump
    into the output dir (dspsr_util.py:192-236)."""

    def __call__(self, file_path: str, dump_stage: str = "Detection", **kwargs):
        extra = kwargs.pop("extra_args", "")
        ar, log = super().__call__(
            file_path, extra_args=f"{extra} -dump {dump_stage}", **kwargs
        )
        dump_name = f"pre_{dump_stage}.dump"
        if os.path.exists(dump_name):
            dest = os.path.join(self.output_dir, dump_name)
            if os.path.abspath(dump_name) != os.path.abspath(dest):
                shutil.move(dump_name, dest)
            return dest, ar, log
        return None, ar, log


class PsrdiffRunner(BaseRunner):
    tool = "psrdiff"

    def __call__(self, file_paths, output_file_name="psrdiff.out", **kwargs):
        self.check_available()
        out = os.path.join(self.output_dir, output_file_name)
        cmd = f"{self.tool} {' '.join(file_paths)}"
        util.run_cmd(cmd, log_file_path=out)
        return out


class PsrtxtRunner(BaseRunner):
    tool = "psrtxt"

    def __call__(self, file_path, output_file_name="psrtxt.out", **kwargs):
        self.check_available()
        out = os.path.join(self.output_dir, output_file_name)
        util.run_cmd(f"{self.tool} {file_path}", log_file_path=out)
        return out


# module-level singletons, like the reference
run_dspsr = DspsrRunner()
run_dspsr_with_dump = DspsrDumpRunner()
run_psrdiff = PsrdiffRunner()
run_psrtxt = PsrtxtRunner()


def load_psrtxt_data(file_path: str) -> np.ndarray:
    """Columns of a psrtxt dump as a float array (dspsr_util.py:317-332)."""
    rows = []
    with open(file_path) as f:
        for line in f:
            parts = line.split()
            if parts:
                rows.append([float(p) for p in parts])
    return np.asarray(rows).T


def find_in_log(log_file_path: str, keyword: str) -> typing.Optional[str]:
    """Scrape ``keyword=value`` (or 'keyword value') out of a tool log
    (dspsr_util.py:335-361)."""
    pattern = re.compile(
        rf"{re.escape(keyword)}\s*[:=]?\s*([-+0-9.eE/]+)"
    )
    with open(log_file_path) as f:
        for line in f:
            m = pattern.search(line)
            if m:
                return m.group(1)
    return None
