"""Backend: milliseconds of the program's backend/diffs spans (the net
diffs of every touched object, `_emit_diffs`, backend/device.py) per
session of the window. The stage spans run in the load's replay of the
base change and in the merge alike, so this counts both."""


def read(r):
    sessions = len(r.seconds("session"))
    if "backend.diffs" not in r.obs_spans or not sessions:
        return None
    return r.obs_seconds("backend.diffs") * 1e3 / sessions
