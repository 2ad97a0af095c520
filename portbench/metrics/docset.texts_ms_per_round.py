"""Read: mean milliseconds of the benchmark-side span around texts(),
over the window's rounds."""


def read(r):
    s = r.seconds("round/texts")
    return float(s.mean()) * 1e3 if len(s) else None
