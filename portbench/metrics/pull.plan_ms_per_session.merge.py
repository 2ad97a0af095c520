"""Read: milliseconds text() spends planning segments on the host and
launching the materialization (the program's pull/plan spans) per
session of the window."""


def read(r):
    sessions = len(r.seconds("session/read"))
    if "pull.plan" not in r.obs_spans or not sessions:
        return None
    return r.obs_seconds("pull.plan") * 1e3 / sessions
