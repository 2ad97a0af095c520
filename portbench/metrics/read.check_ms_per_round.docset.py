"""Read: milliseconds texts() spends checking every row's fetched
checksums against its mirror (the program's read/check spans) per round
of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "read.check" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("read.check") * 1e3 / rounds
