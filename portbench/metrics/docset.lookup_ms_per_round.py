"""Doc set: milliseconds of the lookups of each planned document's run
parents in its merged index (the program's docset/lookup spans,
aggregates only) per round of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "docset.lookup" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("docset.lookup") * 1e3 / rounds
