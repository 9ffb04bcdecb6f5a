"""File bytes over the host time of ``load_split`` to a synchronised
complex64 tensor on the card (the ``ingest`` span), totalled over the
traced requests, in GB/s."""


def read(run):
    t = run.trace
    spans = [] if t is None else [b - a for n, a, b in t.spans if n == "ingest"]
    if not spans or not run.bytes_per_request:
        return None
    return run.bytes_per_request * len(spans) / (sum(spans) / 1e6) / 1e9
