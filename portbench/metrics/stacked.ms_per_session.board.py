"""Stacked rounds: milliseconds of the program's plan/stack and
commit/stacked_round spans (engine/stacked.py apply_stacked: decode,
admission and planning of every touched object, then its round programs)
per session of the window. The stage spans run in the load's replay of
the base change and in the merge alike, so this counts both."""


def read(r):
    sessions = len(r.seconds("session"))
    keys = ("plan.stack", "commit.stacked_round")
    if not any(k in r.obs_spans for k in keys) or not sessions:
        return None
    return r.obs_seconds(*keys) * 1e3 / sessions
