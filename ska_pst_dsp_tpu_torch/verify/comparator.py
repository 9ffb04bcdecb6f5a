"""Array comparison framework.

The port's copy of :mod:`ska_pst_dsp_tpu.verify.comparator` (host numpy:
the operators and products are numpy callables). Native replacement for
the external ``comparator`` package the reference harness leans on
(SingleDomainComparator / FrequencyDomainComparator /
MultiDomainComparator with registries of operators and products,
purity.py:144-160): compare N arrays through a set of *operators* (identity,
difference, ...) and reduce each operator result with a set of scalar
*products* (mean, max spurious power, ...), in one or more domains
(time, frequency).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


class _Registry(dict):
    def __setitem__(self, key, value):
        if not callable(value):
            raise TypeError(f"{key} must be callable")
        super().__setitem__(key, value)


class SingleDomainComparator:
    """Compare arrays elementwise in one domain.

    Operators are unary (applied per array) or binary (applied per ordered
    pair); products reduce operator outputs to scalars. Results are keyed
    ``result[op][i]`` (unary) or ``result[op][i, j]`` (binary).
    """

    def __init__(self, name: str, transform: Optional[Callable] = None):
        self.name = name
        self._transform = transform
        self.domain: Optional[Sequence[int]] = None  # [lo, hi) slice
        self.operators: Dict[str, Callable] = _Registry()
        self.products: Dict[str, Callable] = _Registry()

    def _prep(self, arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
        n = min(a.size for a in arrays)
        out = []
        for a in arrays:
            a = np.asarray(a).ravel()[:n]
            if self._transform is not None:
                a = self._transform(a)
            if self.domain is not None:
                a = a[self.domain[0]: self.domain[1]]
            out.append(a)
        return out

    def __call__(self, *arrays):
        arrays = self._prep(arrays)
        op_results: Dict[str, dict] = {}
        prod_results: Dict[str, dict] = {}
        for op_name, op in self.operators.items():
            n_args = op.__code__.co_argcount
            results = {}
            if n_args == 1:
                for i, a in enumerate(arrays):
                    results[(i,)] = op(a)
            else:
                for i, a in enumerate(arrays):
                    for j, b in enumerate(arrays):
                        if i == j:
                            continue
                        results[(i, j)] = op(a, b)
            op_results[op_name] = _OpResult(results)
            prod_results[op_name] = _OpResult(
                {
                    key: {p: fn(val) for p, fn in self.products.items()}
                    for key, val in results.items()
                }
            )
        return op_results, prod_results


class _OpResult:
    """Index by [i] or [i, j] like the reference comparator results."""

    def __init__(self, mapping: dict):
        self._m = mapping

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        return self._m[key]

    def items(self):
        return self._m.items()

    def __repr__(self):
        return f"_OpResult({list(self._m)})"


class FrequencyDomainComparator(SingleDomainComparator):
    """Compare in the Fourier domain (comparator's FrequencyDomain role)."""

    def __init__(self, name: str = "freq"):
        super().__init__(name, transform=lambda a: np.fft.fft(a))


class TimeDomainComparator(SingleDomainComparator):
    def __init__(self, name: str = "time"):
        super().__init__(name)


class MultiDomainComparator:
    """Bundle of domain comparators sharing operator/product registries;
    domains are attributes (comp.time(...), comp.freq(...))."""

    def __init__(self, domains: Dict[str, SingleDomainComparator]):
        self._domains = domains
        self.operators: Dict[str, Callable] = _Registry()
        self.products: Dict[str, Callable] = _Registry()
        for name, d in domains.items():
            setattr(self, name, d)

    def _sync(self):
        for d in self._domains.values():
            d.operators.update(self.operators)
            d.products.update(self.products)

    def __getattribute__(self, name):
        # keep shared registries pushed down before any domain call
        v = object.__getattribute__(self, name)
        if isinstance(v, SingleDomainComparator):
            object.__getattribute__(self, "_sync")()
        return v
