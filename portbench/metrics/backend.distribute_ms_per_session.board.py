"""Backend: milliseconds of the program's backend/distribute spans (the
admitted changes routed to the object engines and applied, stacked or
object by object, backend/device.py) per session of the window. The
stage spans run in the load's replay of the base change and in the
merge alike, so this counts both."""


def read(r):
    sessions = len(r.seconds("session"))
    if "backend.distribute" not in r.obs_spans or not sessions:
        return None
    return r.obs_seconds("backend.distribute") * 1e3 / sessions
