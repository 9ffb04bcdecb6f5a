"""Shared CLI argument parser for the verification harness.

The port's copy of :mod:`ska_pst_dsp_tpu.verify.common`, the equivalent of
python/verify/common.py:9-42, with ``--device`` (the torch device of the
``torch`` backend; default the card)."""

from __future__ import annotations

import argparse

__all__ = ["create_parser"]


def create_parser(**kwargs) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(**kwargs)
    parser.add_argument("-t", "--do-time", dest="do_time", action="store_true")
    parser.add_argument("-f", "--do-freq", dest="do_freq", action="store_true")
    parser.add_argument("-n", "--n-test", dest="n_test", action="store",
                        default=100, type=int,
                        help="number of test vectors to use")
    parser.add_argument("-c", "--config", dest="sub_config_name",
                        action="store", default="low", type=str,
                        help="which sub configuration to use")
    parser.add_argument("--save-output", dest="save_output",
                        action="store_true",
                        help="keep intermediate products")
    parser.add_argument("--extra-args", dest="extra_args", action="store",
                        default="", type=str,
                        help="extra arguments for external synthesizers")
    parser.add_argument("-b", "--backend", dest="backend", action="store",
                        default=None, type=str,
                        help="override backend (torch or numpy)")
    parser.add_argument("--device", dest="device", action="store",
                        default="cuda", type=str,
                        help="torch device of the torch backend (default: the card)")
    parser.add_argument("-v", "--verbose", dest="verbose",
                        action="store_true")
    return parser
