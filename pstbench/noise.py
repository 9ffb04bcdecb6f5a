"""Seeded complex noise, made on the device in one call.

A plain counterpart of the program's ``models.signals.GaussianNoise``:
unit variance per quadrature, drawn from one ``torch.Generator`` on the
device seeded from (seed, stream), so the same seed gives the same samples
on the same kind of device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from the whole numbers (seed, stream)."""
    key = int(np.random.SeedSequence([seed % 2**64, stream]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=torch.device(device)).manual_seed(key)


def complex_noise(shape: Sequence[int], seed: int, stream: int, device) -> torch.Tensor:
    """complex64 noise of ``shape`` on ``device``."""
    dev = torch.device(device)
    parts = torch.randn((2, *shape), generator=generator(seed, stream, dev), device=dev)
    return torch.complex(parts[0], parts[1])
