from .round_trip import PaddedPFBRoundTrip, PFBRoundTrip  # noqa: F401
