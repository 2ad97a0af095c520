"""Doc set: milliseconds of the run detection of every document the
fast tier plans (the program's plan/detect_runs spans, aggregates only)
per round of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "plan.detect_runs" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("plan.detect_runs") * 1e3 / rounds
