"""Doc set: mean milliseconds of the benchmark-side span around
apply_batches, over the window's rounds."""


def read(r):
    s = r.seconds("round/apply")
    return float(s.mean()) * 1e3 if len(s) else None
