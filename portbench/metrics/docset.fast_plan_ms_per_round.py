"""Doc set: milliseconds of the fast tier's planning of every document
(the program's docset/plan span) per round of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "docset.plan" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("docset.plan") * 1e3 / rounds
