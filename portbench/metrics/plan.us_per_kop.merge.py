"""Host planning: microseconds of the program's plan/prepare_batch spans
per 1,000 merged ops (the ring's worker plans through prepare_batch too,
so its ring/plan span would count the same time twice)."""


def read(r):
    if "plan.prepare_batch" not in r.obs_spans or not r.n_ops:
        return None
    return r.obs_seconds("plan.prepare_batch") * 1e6 / (r.n_ops / 1e3)
