"""Read: milliseconds a session's text() spends in blocking fetches (the
program's pull/wait spans) per session of the window."""


def read(r):
    sessions = len(r.seconds("session/read"))
    if "pull.wait" not in r.obs_spans or not sessions:
        return None
    return r.obs_seconds("pull.wait") * 1e3 / sessions
