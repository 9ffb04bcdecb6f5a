"""Rational oversampling-factor arithmetic.

The port's copy of :mod:`ska_pst_dsp_tpu.utils.rational`: the equivalent of
the reference's rational helpers (matlab/normalize.m:18, multiply.m:18, and
the external Python ``pfb.rational.Rational`` the reference harness
imports).

An oversampled PFB is described by a ratio nu/de > 1 (e.g. 4/3 for SKA-Low,
8/7 for SKA-Mid): the channelizer advances ``step = n_chan*de/nu`` input
samples per output spectrum, so fine-channel data are oversampled by nu/de.
All derived block geometry in the framework flows through this type, and the
arithmetic must stay exact (integer), which is why this is not a float.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction


@dataclasses.dataclass(frozen=True)
class Rational:
    """Exact rational number ``nu/de`` used as an oversampling factor."""

    nu: int
    de: int

    def __post_init__(self):
        if self.de <= 0 or self.nu <= 0:
            raise ValueError(f"Rational terms must be positive: {self.nu}/{self.de}")

    # ---- constructors -------------------------------------------------
    @classmethod
    def from_str(cls, s: str) -> "Rational":
        """Parse ``"nu/de"`` (the format used in config files and DADA
        OS_FACTOR / OVERSAMP_<i> header keys)."""
        nu, de = s.split("/")
        return cls(int(nu), int(de))

    @classmethod
    def coerce(cls, value) -> "Rational":
        """Accept a Rational, a "nu/de" string, a (nu, de) tuple, or a
        mapping with nu/de keys (the reference's os_factor struct shape), or
        any object with integer ``nu`` and ``de`` attributes (such as the
        JAX package's Rational)."""
        if isinstance(value, cls):
            return value
        if hasattr(value, "nu") and hasattr(value, "de"):
            return cls(int(value.nu), int(value.de))
        if isinstance(value, str):
            return cls.from_str(value)
        if isinstance(value, dict):
            return cls(int(value["nu"]), int(value["de"]))
        if isinstance(value, (tuple, list)) and len(value) == 2:
            return cls(int(value[0]), int(value[1]))
        raise TypeError(f"cannot interpret {value!r} as Rational")

    # ---- arithmetic ---------------------------------------------------
    def normalize(self, n: int) -> int:
        """``n * de / nu`` — map an oversampled count to its critically
        sampled equivalent (reference normalize.m:18). Exact division is
        enforced: geometry bugs show up as loud errors, not silent floats."""
        num = n * self.de
        if num % self.nu:
            raise ValueError(f"normalize({n}) by {self} is not integral")
        return num // self.nu

    def multiply(self, n: int) -> int:
        """``n * nu / de`` — inverse of :meth:`normalize` (multiply.m:18)."""
        num = n * self.nu
        if num % self.de:
            raise ValueError(f"multiply({n}) by {self} is not integral")
        return num // self.de

    def normalize_floor(self, n: int) -> int:
        """``floor(n * de / nu)`` — used for the commutator step where the
        reference floors (polyphase_analysis.m:56)."""
        return (n * self.de) // self.nu

    # ---- conversions --------------------------------------------------
    @property
    def fraction(self) -> Fraction:
        return Fraction(self.nu, self.de)

    def __float__(self) -> float:
        return self.nu / self.de

    def __str__(self) -> str:
        return f"{self.nu}/{self.de}"

    def __eq__(self, other) -> bool:
        if isinstance(other, Rational):
            return self.nu * other.de == other.nu * self.de
        return NotImplemented

    def __hash__(self):
        return hash(Fraction(self.nu, self.de))


#: Critically sampled (no oversampling).
UNITY = Rational(1, 1)
