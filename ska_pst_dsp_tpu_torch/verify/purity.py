"""Temporal and spectral purity of the PFB inversion.

The port's counterpart of :mod:`ska_pst_dsp_tpu.verify.purity`, the
equivalent of python/verify/purity.py:31-347 (TestPurity): sweep impulse
offsets across the stream and tone frequencies across the band, run each
vector through generate → channelize → invert (the port's ``data_gen``
files), align (``chop``) against the input, and report reconstruction
differences plus spurious-power metrics against the SKAO −60 dB
requirements.

Backends are the port's ``data_gen`` ones: ``torch`` (the default) runs the
fused drop-ins on ``device`` (default the card, where the CUDA kernels run;
their plain versions on the CPU), ``numpy`` the fp64 oracle. The JSON report
lands in ``products/report.purity.<params>.<device type>.json``, never under
the name of the JAX package's committed reports.

The constructor signature, method names and report schema match the
reference harness (the compatibility surface a reference user scripts
against).

Run:  python -m ska_pst_dsp_tpu_torch.verify.purity -t -f -n 10 -c low
"""

from __future__ import annotations

import functools
import glob
import json
import logging
import os
from typing import Optional, Union

import numpy as np
import torch

from .. import data_gen
from ..data_gen.config import products_dir
from ..utils import geometry
from ..utils.rational import Rational
from . import util as test_util
from .common import create_parser

module_logger = logging.getLogger(__name__)

__all__ = ["TestPurity", "port_backend"]

#: report-section names (the reference harness's method names — the report
#: schema is the compatibility surface)
_METHOD_NAMES = {"time": "test_time_domain_impulse",
                 "freq": "test_complex_sinusoid"}


def port_backend(name: str) -> str:
    """The port's backend for a name from ``config/test.config.json``, which
    both packages read: its ``jax`` (the JAX package's kernels) is the
    port's ``torch``; any other name is kept (``data_gen`` judges it)."""
    return "torch" if name == "jax" else name


class TestPurity:
    __test__ = False  # not a pytest class

    thresh = 1e-7  # purity.py:33

    time_domain_args = {"width": 1}
    freq_domain_args = {"phase": np.pi / 4, "bin_offset": 0.0}

    def __init__(
        self,
        n_test: int,
        os_factor: Union[Rational, str],
        input_fft_length: int,
        input_overlap: int,
        fft_window: str,
        deripple: bool,
        channels: int,
        fir_filter_taps: int,
        blocks: int,
        backend: Optional[dict] = None,
        output_dir: Optional[str] = None,
        save_output: bool = False,
        make_plots: Optional[bool] = None,
        analysis_function: str = "polyphase_analysis",
        fir_filter_path: Optional[str] = None,
        device: str = "cuda",
    ):
        backend = backend or {}
        backend = {k: backend.get(k, "torch")
                   for k in ("test_vectors", "channelize", "synthesize")}
        self.device = device
        self.make_plots = (n_test == 1) if make_plots is None else make_plots
        self.input_fft_length, self.input_overlap = (
            input_fft_length, input_overlap
        )
        self.deripple, self.fft_window = deripple, fft_window
        self.save_output, self.channels = save_output, channels
        self.output_dir = output_dir or data_gen.config.config.data_dir
        for d in (self.output_dir, products_dir):
            os.makedirs(d, exist_ok=True)
        # per instance: the class attributes are the defaults
        self.time_domain_args = dict(self.time_domain_args)
        self.freq_domain_args = dict(self.freq_domain_args)

        os_factor = Rational.coerce(os_factor)
        # derived block geometry (the reference harness's sizing rules)
        self.normalize = input_fft_length * channels
        self.block_size = os_factor.normalize(input_fft_length) * channels
        block_size = self.block_size
        self.fft_size = 2 * block_size
        self.n_samples = block_size * blocks
        self.output_sample_shift = (
            os_factor.normalize(input_overlap) * channels
        )
        self.use_padded = analysis_function == "polyphase_analysis_padded"
        self.total_sample_shift = geometry.total_sample_shift(
            channels, os_factor, fir_filter_taps, input_overlap,
            padded=self.use_padded,
        )
        self.os_factor = os_factor

        if n_test == 1:
            self.time_domain_args["offset"] = [10 + self.total_sample_shift]
            self.freq_domain_args["frequency"] = [1 * blocks]
        else:
            self.time_domain_args["offset"] = np.linspace(
                1, self.n_samples, n_test
            ).astype(int)
            self.freq_domain_args["frequency"] = (
                np.linspace(1, block_size, n_test).astype(int) * blocks
            )

        self.generator = data_gen.generate_test_vector(
            backend=backend["test_vectors"], n_bins=self.n_samples
        )
        # the sub-config's geometry explicitly: the channelize factory
        # otherwise falls back to the module-level default config
        self.channelizer = data_gen.channelize(
            backend=backend["channelize"],
            channels=channels,
            os_factor_str=str(os_factor),
            use_padded=self.use_padded,
            device=device,
            **(
                {"fir_filter_path": fir_filter_path}
                if fir_filter_path
                else {}
            ),
        )
        identity = lambda a, **kwargs: a  # noqa: E731 — no synthesize stage
        self.pipeline = data_gen.pipeline(
            self.generator, self.channelizer, identity,
            output_dir=self.output_dir,
        )
        self.synthesizer = functools.partial(
            data_gen.synthesize,
            apply_deripple=deripple,
            backend=backend["synthesize"],
            fft_window_str=fft_window,
            input_fft_length=input_fft_length,
            input_overlap=input_overlap,
            output_dir=self.output_dir,
            device=device,
        )

        self.report: dict = {}
        self.files: list = []

    # ------------------------------------------------------------------
    def _run_case(self, domain: str, arg) -> dict:
        """One sweep point: generate the vector through the gen→channelize
        pipeline, invert it, align, and score. ``domain`` picks the signal
        kind and which view the spurious metrics are taken in (the
        residual-vs-input differences are always time-domain)."""
        if domain == "time":
            dump_files = self.pipeline(
                arg, self.time_domain_args["width"], domain_name="time"
            )
        else:
            dump_files = self.pipeline(
                arg, self.freq_domain_args["phase"],
                self.freq_domain_args["bin_offset"], domain_name="freq",
            )
        inverted_dump = self.synthesizer(dump_files[1].file_path)
        inp, inv = self.chop(dump_files[0], inverted_dump)
        self.files.extend(dump_files)
        self.files.append(inverted_dump)

        n = min(inp.size, inv.size)
        inp, inv = inp[:n], inv[:n]
        resid = np.abs(inv - inp)
        if domain == "freq":
            # spurious power is judged in the band: unit-scaled spectrum
            # over the leading fft_size bins (2 inversion blocks)
            target = np.fft.fft(inv / self.fft_size)[: self.fft_size]
        else:
            target = inv
        case = {
            "mean_diff": float(np.mean(resid)),
            "total_diff": float(np.sum(resid)),
            "max_spurious_power": test_util.max_spurious(target),
            "total_spurious_power": test_util.total_spurious(target),
            "mean_spurious_power": test_util.mean_spurious(target),
            "arg": int(arg),
        }
        if self.make_plots:
            spec = {
                "this": {0: np.fft.fft(inp / self.fft_size)[: self.fft_size],
                         1: target if domain == "freq" else
                         np.fft.fft(inv / self.fft_size)[: self.fft_size]},
                "diff": {0: np.fft.fft((inv - inp) / self.fft_size)
                         [: self.fft_size]},
            }
            fig, _ = test_util.plot_freq_domain_comparison(
                {"this": {0: inp, 1: inv}}, spec,
                subplots_kwargs=dict(figsize=(10, 14)),
                labels=["Input data", "InverseFilterbank"],
            )
            name = _METHOD_NAMES[domain]
            fig.suptitle(f"{name} {arg}")
            fig.savefig(os.path.join(products_dir, f"{name}.{arg}.{self._tag()}.png"))
        return case

    def _tag(self) -> str:
        return torch.device(self.device).type

    def _sweep(self, domain: str, args) -> list:
        name = _METHOD_NAMES[domain]
        rows = []
        for arg in args:
            case = self._run_case(domain, arg)
            rows.append(case)
            module_logger.info("%s arg=%s: %s", name, arg, case)
            if not self.save_output:
                self.dispose()
        self.report[name] = rows
        return rows

    def temporal_purity(self):
        return self._sweep("time", self.time_domain_args["offset"])

    def spectral_purity(self):
        return self._sweep("freq", self.freq_domain_args["frequency"])

    def chop(self, input_dump_file, inverted_dump_file):
        """Align the inverted stream against the input by dropping
        total_sample_shift input samples (purity.py:276-283)."""
        shifted = input_dump_file.data[self.total_sample_shift:, 0, :]
        return shifted.ravel(), inverted_dump_file.data.ravel()

    def dispose(self):
        for f in self.files:
            path = getattr(f, "file_path", f)
            if os.path.exists(path):
                os.remove(path)
        self.files = []
        for path in glob.glob(os.path.join(self.output_dir, "channelized.*")):
            os.remove(path)

    def finish(self) -> str:
        params = {
            "fft_length": self.input_fft_length,
            "deripple": int(self.deripple),
            "fft_window": self.fft_window,
            "input_overlap": self.input_overlap,
        }
        param_str = ".".join(f"{k}-{v}" for k, v in params.items())
        path = os.path.join(products_dir, f"report.purity.{param_str}.{self._tag()}.json")
        with open(path, "w") as f:
            json.dump(self.report, f, cls=data_gen.util.NumpyEncoder, indent=2)
        module_logger.info("purity report written to %s", path)
        return path


def run(argv=None) -> str:
    """The CLI: sweep the config's geometry; returns the report's path."""
    parsed = create_parser(
        description="PFB inversion purity verification"
    ).parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if parsed.verbose else logging.INFO
    )
    logging.getLogger("matplotlib").setLevel(logging.ERROR)

    config = data_gen.config.load_config(parsed.sub_config_name)
    backend = {k: port_backend(v) for k, v in (config.backend or {}).items()}
    if parsed.backend:
        backend = {k: parsed.backend for k in ("test_vectors", "channelize", "synthesize")}

    purity_test = TestPurity(
        n_test=parsed.n_test,
        os_factor=config.os_factor,
        input_fft_length=config.input_fft_length,
        input_overlap=config.input_overlap,
        fft_window=config.temporal_taper,
        deripple=config.deripple,
        channels=config.channels,
        fir_filter_taps=config.fir_filter_taps,
        blocks=config.blocks,
        backend=backend,
        save_output=parsed.save_output,
        analysis_function=config.analysis_function,
        fir_filter_path=getattr(config, "fir_filter_path", None),
        device=parsed.device,
    )
    for flag, method in (("do_time", purity_test.temporal_purity),
                         ("do_freq", purity_test.spectral_purity)):
        if getattr(parsed, flag):
            method()
    return purity_test.finish()


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main()
