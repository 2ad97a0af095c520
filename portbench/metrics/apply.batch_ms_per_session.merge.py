"""Apply path: milliseconds of the program's apply/batch spans per
session of the window (the merge through apply_batch, without the
ring)."""


def read(r):
    sessions = len(r.seconds("session/merge"))
    if "apply.batch" not in r.obs_spans or not sessions:
        return None
    return r.obs_seconds("apply.batch") * 1e3 / sessions
