"""Checkpoint: mean milliseconds of the program's ckpt/restore span (one
a session: the bundle decoded, the index, the tables staged and the
mirror rebuilt)."""


def read(r):
    agg = r.obs_spans.get("ckpt.restore")
    if not agg:
        return None
    return agg["total_ns"] / 1e6 / agg["count"]
