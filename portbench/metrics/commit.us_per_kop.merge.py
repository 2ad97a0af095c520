"""Commit and round programs: microseconds of the program's commit/batch
spans per 1,000 merged ops (ring/commit wraps the same commit)."""


def read(r):
    if "commit.batch" not in r.obs_spans or not r.n_ops:
        return None
    return r.obs_seconds("commit.batch") * 1e6 / (r.n_ops / 1e3)
