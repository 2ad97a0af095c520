"""Read: milliseconds texts() spends stacking every row's segment plan
(the program's read/plan spans) per round of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "read.plan" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("read.plan") * 1e3 / rounds
