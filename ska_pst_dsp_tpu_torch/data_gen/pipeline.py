"""Pipeline composition: generate → channelize → synthesize.

The port's copy of :mod:`ska_pst_dsp_tpu.data_gen.pipeline`, the
equivalent of python/data_gen/pipeline.py:13-86: compose the three stage
callbacks into one callable that persists every intermediate product
(``channelized.*`` / ``synthesized.*``) — each stage re-runnable from disk.
"""

from __future__ import annotations

import logging
import os

__all__ = ["pipeline"]

module_logger = logging.getLogger(__name__)


def pipeline(
    test_vector_callback,
    channelize_callback,
    synthesize_callback,
    output_dir: str = "./",
):
    """Return callable(*args, **kwargs) → (input, channelized, synthesized)
    DADAFiles; args flow to the test-vector callback."""

    def _pipeline(*args, **kwargs):
        module_logger.debug("_pipeline: args=%s kwargs=%s", args, kwargs)
        test_vector_dada_file = test_vector_callback(
            *args, **kwargs, output_dir=output_dir
        )
        base = os.path.basename(test_vector_dada_file.file_path)
        channelized = channelize_callback(
            test_vector_dada_file.file_path,
            output_file_name="channelized." + base,
            output_dir=output_dir,
        )
        synthesized = synthesize_callback(
            channelized.file_path,
            output_file_name="synthesized." + base,
            output_dir=output_dir,
        )
        return test_vector_dada_file, channelized, synthesized

    return _pipeline
