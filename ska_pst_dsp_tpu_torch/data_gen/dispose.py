"""Intermediate-product cleanup.

The port's copy of :mod:`ska_pst_dsp_tpu.data_gen.dispose`, the
equivalent of python/data_gen/dispose.py:12-85: a context manager that
deletes the files backing pipeline products on exit (unless told to keep
them), so purity sweeps don't fill the disk with DADA dumps.
"""

from __future__ import annotations

import contextlib
import logging
import os

__all__ = ["dispose"]

module_logger = logging.getLogger(__name__)


@contextlib.contextmanager
def dispose(*file_like, dispose_all: bool = False, keep: bool = False):
    """Yield the given DADAFile-like objects (or paths); delete their files
    on exit. With ``dispose_all=False`` the first item (the pipeline input)
    is kept, matching the reference's default of retaining test vectors."""
    try:
        yield file_like if len(file_like) != 1 else file_like[0]
    finally:
        if keep:
            return
        items = file_like if dispose_all else file_like[1:]
        for item in items:
            path = getattr(item, "file_path", item)
            if isinstance(path, str) and os.path.exists(path):
                module_logger.debug("dispose: removing %s", path)
                os.remove(path)
