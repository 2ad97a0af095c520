"""Doc set: milliseconds of the merges of each planned document's runs
into its element index (the program's plan/index_merge spans,
aggregates only) per round of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "plan.index_merge" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("plan.index_merge") * 1e3 / rounds
