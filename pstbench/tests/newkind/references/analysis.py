"""The plain reference of the ``analysis`` kind: the oversampled
single-stage analysis (polyphase_analysis.m:56-120) in float64, written
from its semantics in plain PyTorch. It imports nothing of the program and
takes only the configuration and the prototype filter.
``precision="bf16"`` rounds the input, the filter, the fold and the
output to bfloat16: the control."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Shape:
    n_chan: int
    step: int
    fl: int  # taps padded to whole channels


def _bf16(t: torch.Tensor) -> torch.Tensor:
    if t.is_complex():
        return torch.complex(_bf16(t.real), _bf16(t.imag))
    return t.to(torch.bfloat16).to(t.dtype)


class Analysis:
    def __init__(self, cfg: dict, filt: np.ndarray, device, precision: str = "fp64"):
        if precision not in ("fp64", "bf16"):
            raise ValueError(f"no {precision} reference")
        nu, de = (int(v) for v in str(cfg["os_factor"]).split("/"))
        n = cfg["channels"]
        self.shape = Shape(n, n * de // nu, -(-filt.size // n) * n)
        self.device = torch.device(device)
        self.q = _bf16 if precision == "bf16" else (lambda t: t)
        f = torch.zeros(self.shape.fl, dtype=torch.float64)
        f[: filt.size] = torch.as_tensor(filt, dtype=torch.float64)
        self.filt = self.q(f.to(self.device))

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """(n_pol, n_dat) -> time-major spectra (n_pol, nb, n_chan), nb =
        (n_dat - fl) // step: each window of fl samples (hop step) times
        the filter, folded onto n_chan, shifted circularly by step * k mod
        n_chan, n_chan * FFT."""
        s = self.shape
        x = self.q(x.to(self.device, torch.complex128))
        frames = x.unfold(-1, s.fl, s.step)[:, : (x.shape[-1] - s.fl) // s.step]
        folded = self.q((frames * self.filt).reshape(
            *frames.shape[:2], s.fl // s.n_chan, s.n_chan).sum(dim=-2))
        k = torch.arange(frames.shape[1], device=self.device)
        j = torch.arange(s.n_chan, device=self.device)
        idx = (j[None, :] - (s.step * k)[:, None]) % s.n_chan
        rolled = folded.gather(-1, idx.expand(x.shape[0], -1, -1))
        return self.q(torch.fft.fft(rolled, dim=-1) * s.n_chan)
