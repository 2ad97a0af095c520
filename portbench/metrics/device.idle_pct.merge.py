"""Device: the share of the traced window in which no operation ran on
the card (profiler trace)."""


def read(r):
    return r.idle_pct()
