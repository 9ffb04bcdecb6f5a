from .round_trip import PFBRoundTrip  # noqa: F401
