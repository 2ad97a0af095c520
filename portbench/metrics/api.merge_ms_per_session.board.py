"""API: milliseconds of the program's api/merge spans (the one
am.apply_changes of a session's backlog: validation, the backend's apply
and the frontend's patch) per session of the window."""


def read(r):
    sessions = len(r.seconds("session"))
    if "api.merge" not in r.obs_spans or not sessions:
        return None
    return r.obs_seconds("api.merge") * 1e3 / sessions
