"""encode_p95_ms: the 95th percentile of the host times of every call in
the window (linear between order statistics), ms (the ingest cells)."""


def read(run):
    return run.p95_ms()
