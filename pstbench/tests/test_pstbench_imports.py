"""What the benchmark loads: no JAX and no JAX package in a run's
process, and nothing of the program in the references (the round trip's,
and each kind's in pstbench/references/)."""

import json
import os
import subprocess
import sys

import pytest

from pstbench import run

RUN_SMALL = """
import json, sys
from pstbench import run
from pstbench.tests.conftest import SMALL
bench = run.load_json(run.ROOT / "BENCHMARK.json")
res = run.run(bench, "low.oneshot", 2**31 + 7, 0.2, False, device="cpu",
              traffic_params=SMALL["low.oneshot"])
import pstbench.control, pstbench.reference, pstbench.generator
from pstbench.tests.conftest import NEWKIND
for folder in ("metrics", "kinds"):
    for p in sorted((run.HERE / folder).glob("*.py")) + sorted((NEWKIND / folder).glob("*.py")):
        run.load_module(p)
print(json.dumps({"correct": res["correct"],
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""

REFERENCE_ONLY = """
import json, sys
from pathlib import Path
import pstbench.reference, pstbench.design, pstbench.stats, pstbench.roofline
import pstbench.dadafile, pstbench.noise
from pstbench.run import HERE, load_module
newkind = HERE / "tests" / "newkind"
files = sorted((HERE / "references").glob("*.py")) + sorted((newkind / "references").glob("*.py"))
for p in files:
    load_module(p)
print(json.dumps({"files": [str(p) for p in files],
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


LATE_IMPORT = """
import contextlib, io, json, sys, types
import torch
from pstbench import run
from pstbench.tests.conftest import SMALL
real_run, real_load = run.run, run.load_module


def load_module(path):
    mod = real_load(path)
    read = mod.read

    def read_and_import(record):
        if LOADS_JAX:
            sys.modules.setdefault("jax", types.ModuleType("jax"))
        return read(record)
    mod.read = read_and_import
    return mod


torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
run.load_module = load_module
run.run = lambda *a, **k: real_run(*a, device="cpu", traffic_params=SMALL["low.oneshot"], **k)
out, err = io.StringIO(), io.StringIO()
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
    rc = run.main(["--workload", "low.oneshot", "--seed", str(2**31 + 11),
                   "--seconds", "0.2", "--trace", "0"])
print(json.dumps({"rc": rc, "out": out.getvalue(), "err": err.getvalue()}))
"""


def _python(code):
    env = dict(os.environ, PYTHONPATH=str(run.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    res = _python(RUN_SMALL)
    assert res["correct"]
    assert {"ska_pst_dsp_tpu_torch", "pstbench_kinds_analysis"} <= set(res["top"])
    assert not set(res["top"]) & set(run.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    res = _python(REFERENCE_ONLY)
    top = res["top"]
    assert any(f.endswith("newkind/references/analysis.py") for f in res["files"])
    assert "torch" in top and "pstbench_references_analysis" in top
    assert not set(top) & {"ska_pst_dsp_tpu_torch", *run.FORBIDDEN}


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("ska_pst_dsp_tpu_torch_like", sys)
    try:
        assert "ska_pst_dsp_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["ska_pst_dsp_tpu_torch_like"]


@pytest.mark.parametrize("loads_jax", [False, True])
def test_a_module_loaded_after_the_window_withholds_the_result(loads_jax):
    """A metric's reader that loads JAX, after the window has closed:
    the run names it, exits with code 3 and prints no result line."""
    res = _python(f"LOADS_JAX = {loads_jax}\n" + LATE_IMPORT)
    lines = res["out"].strip().splitlines()
    if loads_jax:
        assert res["rc"] == 3
        assert lines == []
        assert "jax" in res["err"]
    else:
        assert res["rc"] == 0
        assert json.loads(lines[-1])["correct"]
