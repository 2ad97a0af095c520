"""Checkpoint: mean milliseconds of a session's document open (the
benchmark-side span around checkpoint.restore_engine)."""


def read(r):
    s = r.seconds("session/open")
    return float(s.mean()) * 1e3 if len(s) else None
