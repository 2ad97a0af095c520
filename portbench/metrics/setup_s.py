"""Set-up: process start to the first timed operation (host clock)."""


def read(r):
    return r.setup_s
