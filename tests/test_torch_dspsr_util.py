"""The port's dspsr/psrchive wrappers against the JAX package's, on the
same MOCK binaries.

Every case of tests/test_dspsr_util.py (and the wrapper cases of
tests/test_data_gen.py::TestDspsrUtil), parametrised over both packages'
``data_gen.dspsr_util``: a fake ``dspsr`` (a shell script on a prepended
PATH) reproduces the tool's observable behavior — stdout chatter captured
to the log, an ``.ar`` product, and the ``pre_<Stage>.dump`` file dropped
in the CWD that DspsrDumpRunner must relocate (reference
dspsr_util.py:192-236)."""

import json
import os
import shutil
import stat

import numpy as np
import pytest

from ska_pst_dsp_tpu.data_gen import dspsr_util as jax_dspsr_util
from ska_pst_dsp_tpu.data_gen import util as jax_util
from ska_pst_dsp_tpu_torch.data_gen import dspsr_util as port_dspsr_util
from ska_pst_dsp_tpu_torch.data_gen import util as port_util


@pytest.fixture(params=["jax", "port"])
def dspsr_util(request):
    return {"jax": jax_dspsr_util, "port": port_dspsr_util}[request.param]


@pytest.fixture(params=["jax", "port"])
def dg_util(request):
    return {"jax": jax_util, "port": port_util}[request.param]


def _make_tool(bin_dir, name, script):
    path = os.path.join(str(bin_dir), name)
    with open(path, "w") as f:
        f.write("#!/bin/sh\n" + script)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


@pytest.fixture()
def fake_tools(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    # dspsr: echo the invocation, write <out>.ar, and when -dump is given
    # drop pre_<Stage>.dump in the CWD (like the real tool)
    _make_tool(
        bin_dir, "dspsr",
        '''echo "dspsr invoked: $@"
echo "unloading mock archive"
echo "dm=2.64476"
echo "period: 0.00575745"
out=""
dump=""
prev=""
for arg in "$@"; do
  if [ "$prev" = "-O" ]; then out="$arg"; fi
  if [ "$prev" = "-dump" ]; then dump="$arg"; fi
  prev="$arg"
done
touch "$out.ar"
if [ -n "$dump" ]; then echo mockdump > "pre_$dump.dump"; fi
''',
    )
    _make_tool(bin_dir, "psrdiff", 'echo "psrdiff ok: $@"\n')
    _make_tool(bin_dir, "psrtxt",
               'printf "0 1 0.5 0.25\\n1 1 0.6 0.35\\n2 1 0.7 0.45\\n"\n')
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    return bin_dir


def test_unavailable_raises_clear_error(dspsr_util, tmp_path):
    runner = dspsr_util.DspsrRunner(output_dir=str(tmp_path))
    with pytest.raises(dspsr_util.ToolUnavailable, match="dspsr"):
        runner("x.dump")


def test_run_dspsr(dspsr_util, fake_tools, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    runner = dspsr_util.DspsrRunner(output_dir=str(tmp_path))
    infile = tmp_path / "vector.dump"
    infile.write_bytes(b"\0" * 16)
    ar, log = runner(str(infile), period=0.00575745, dm=2.64476)
    assert os.path.exists(ar) and ar.endswith(".ar")
    assert os.path.exists(log)
    text = open(log).read()
    assert "-c 0.00575745" in text and "-D 2.64476" in text


def test_dump_runner_relocates_dump(dspsr_util, fake_tools, tmp_path, monkeypatch):
    # run from a DIFFERENT cwd: the mock tool drops pre_Convolution.dump
    # there and the runner must move it into output_dir
    workdir = tmp_path / "work"
    workdir.mkdir()
    outdir = tmp_path / "out"
    outdir.mkdir()
    monkeypatch.chdir(workdir)
    runner = dspsr_util.DspsrDumpRunner(output_dir=str(outdir))
    infile = tmp_path / "vector.dump"
    infile.write_bytes(b"\0" * 16)
    dump, ar, log = runner(str(infile), dump_stage="Convolution",
                           dm=1.0, period=0.5)
    assert dump == os.path.join(str(outdir), "pre_Convolution.dump")
    assert os.path.exists(dump)
    assert not os.path.exists(workdir / "pre_Convolution.dump")
    assert os.path.exists(ar)


def test_find_in_log(dspsr_util, fake_tools, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    runner = dspsr_util.DspsrRunner(output_dir=str(tmp_path))
    infile = tmp_path / "v.dump"
    infile.write_bytes(b"\0")
    _, log = runner(str(infile), dm=2.64476)
    assert dspsr_util.find_in_log(log, "dm") == "2.64476"
    assert dspsr_util.find_in_log(log, "period") == "0.00575745"
    assert dspsr_util.find_in_log(log, "absent_keyword") is None


def test_psrtxt_chain_and_parse(dspsr_util, fake_tools, tmp_path):
    runner = dspsr_util.PsrtxtRunner(output_dir=str(tmp_path))
    out = runner("whatever.ar")
    data = dspsr_util.load_psrtxt_data(out)
    assert data.shape == (4, 3)
    np.testing.assert_allclose(data[3], [0.25, 0.35, 0.45])


def test_psrdiff(dspsr_util, fake_tools, tmp_path):
    runner = dspsr_util.PsrdiffRunner(output_dir=str(tmp_path))
    out = runner(["a.ar", "b.ar"])
    assert "psrdiff ok" in open(out).read()


def test_chain_composition(dspsr_util, fake_tools, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    calls = []

    def first(path, **kw):
        calls.append(("first", path))
        return path + ".x"

    def second(path, **kw):
        calls.append(("second", path))
        return path + ".y"

    chained = dspsr_util.BaseRunner.chain(first, second)
    assert chained("f") == "f.x.y"
    assert calls == [("first", "f"), ("second", "f.x")]


def test_tool_unavailable_without_path(dspsr_util, monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert shutil.which("dspsr") is None
    with pytest.raises(dspsr_util.ToolUnavailable):
        dspsr_util.DspsrRunner()("nonexistent.dump")


def test_find_in_log_equals_sign(dspsr_util, tmp_path):
    p = str(tmp_path / "x.log")
    open(p, "w").write("blah\noutput_fft_length = 1024\nother stuff\n")
    assert dspsr_util.find_in_log(p, "output_fft_length") == "1024"


def test_load_psrtxt_rows(dspsr_util, tmp_path):
    p = str(tmp_path / "x.txt")
    open(p, "w").write("1 2 3\n4 5 6\n")
    assert dspsr_util.load_psrtxt_data(p).shape == (3, 2)


def test_numpy_encoder(dg_util):
    s = json.dumps(
        {"a": np.float32(1.5), "b": np.arange(3), "c": np.complex64(1 + 2j)},
        cls=dg_util.NumpyEncoder,
    )
    assert json.loads(s) == {"a": 1.5, "b": [0, 1, 2], "c": [1.0, 2.0]}
