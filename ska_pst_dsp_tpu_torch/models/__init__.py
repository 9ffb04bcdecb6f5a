"""The port's models, exported as the JAX package's ``models`` exports
them (plus the round trips). Each name is imported from its module on
first use, so importing the package loads none of them."""

import importlib

_EXPORTS = {
    "PFBRoundTrip": "round_trip", "PaddedPFBRoundTrip": "round_trip",
    **dict.fromkeys(("PureTone", "Impulse", "SquareWave", "FrequencyComb", "FrequencyWedge",
                     "GaussianNoise", "DADAReadGenerator", "Stream", "make_generator"),
                    "signals"),
    **dict.fromkeys(("FilterBank", "FilterBankState", "InverseFilterBank",
                     "InverseFilterBankState", "StatefulPipeline"), "streaming"),
    **dict.fromkeys(("TwoStageFilterBank", "TwoStageInverseFilterBank"), "two_stage"),
    **dict.fromkeys(("TestPureTone", "TestImpulse", "TestFrequencyComb", "PhaseAverage",
                     "NotModeled"), "testers"),
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    globals()[name] = value
    return value
