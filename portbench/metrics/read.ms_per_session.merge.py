"""Read: mean milliseconds of a session's text() (the benchmark-side span
around it)."""


def read(r):
    s = r.seconds("session/read")
    return float(s.mean()) * 1e3 if len(s) else None
