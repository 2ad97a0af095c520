"""Read: milliseconds texts() spends in blocking fetches (the program's
read/wait spans) per round of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "read.wait" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("read.wait") * 1e3 / rounds
