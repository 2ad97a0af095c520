"""Doc set: milliseconds of each planned document's segment-mirror round
(the program's docset/mirror spans, aggregates only) per round of the
window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "docset.mirror" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("docset.mirror") * 1e3 / rounds
