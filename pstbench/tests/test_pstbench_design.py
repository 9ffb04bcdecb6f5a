"""Filters read from coefficient files (``"filter": {"design": "file"}``).

The only coefficient file the repository commits is LowCBF's firmware taps,
``config/PST_filtertaps.txt``. The ``.npy`` files that appear beside it in
``config/`` are not shipped: the program's ``design.fir.load_or_design``
writes them the first time a configuration is loaded. Read back, they are
the benchmark's own least-squares designs, bit for bit."""

import shutil

import numpy as np
import pytest

from pstbench import design, run

#: the SPS stage-1 channeliser (test.config.json "sps": 256 ch at OS 32/27,
#: 6145 taps), as the benchmark's least-squares design states it
SPS = {"name": "sps", "channels": 256, "os_factor": "32/27", "fir_filter_taps": 6145,
       "filter": {"design": "least_squares", "taps_per_channel": 24, "stopband_weight": 15.0}}


def _file_cfg(name, taps, path):
    return {"name": name, "fir_filter_taps": taps, "filter": {"design": "file", "path": path}}


@pytest.mark.parametrize("name, file", [("low", "Prototype_FIR.new.4-3.256.3072.npy"),
                                        ("sps", "Prototype_FIR.new.32-27.256.6144.npy")])
def test_the_programs_cached_taps_read_back_as_the_design(tmp_path, name, file):
    """The program designs and caches the configuration's taps in a copy of
    config/; read from there, they equal the benchmark's design bitwise."""
    from ska_pst_dsp_tpu_torch.utils.config import load_config

    (tmp_path / "config").mkdir()
    shutil.copy(run.ROOT / "config" / "test.config.json", tmp_path / "config")
    load_config(name, str(tmp_path / "config" / "test.config.json")).load_fir_filter_coeff()
    cfg = run.load_json(run.HERE / "configs" / "low.json") if name == "low" else SPS
    h = design.prototype_filter(_file_cfg(name, cfg["fir_filter_taps"], f"config/{file}"),
                                tmp_path)
    assert h.dtype == np.float64 and h.shape == (cfg["fir_filter_taps"],)
    assert np.array_equal(h, design.prototype_filter(cfg))


def test_lowpsi_firmware_taps_are_read_from_the_committed_text():
    h = design.prototype_filter(_file_cfg("lowpsi", 3072, "config/PST_filtertaps.txt"))
    assert h.dtype == np.float64 and h.shape == (3072,)
    assert np.array_equal(h, np.loadtxt(run.ROOT / "config" / "PST_filtertaps.txt"))


def test_a_wrong_tap_count_is_refused():
    with pytest.raises(ValueError, match="3072 taps, not 3073"):
        design.prototype_filter(_file_cfg("lowpsi", 3073, "config/PST_filtertaps.txt"))


def test_a_path_outside_the_root_is_refused(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    np.save(tmp_path / "outside.npy", np.ones(8))
    for path in ("../outside.npy", str(tmp_path / "outside.npy")):
        with pytest.raises(ValueError, match="outside"):
            design.prototype_filter(_file_cfg("x", 8, path), root)


@pytest.mark.parametrize("name, content", [("two_rows.npy", np.ones((2, 4))),
                                           ("not_finite.txt", "1.0 nan 2.0\n")])
def test_taps_that_are_not_one_finite_row_are_refused(tmp_path, name, content):
    if name.endswith(".npy"):
        np.save(tmp_path / name, content)
    else:
        (tmp_path / name).write_text(content)
    with pytest.raises(ValueError, match="not one finite row"):
        design.coefficient_file(name, tmp_path)
