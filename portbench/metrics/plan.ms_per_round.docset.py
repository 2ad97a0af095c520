"""Host planning: milliseconds of all the program's plan/* spans per
round of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if not rounds:
        return None
    total = sum(v["total_ns"] for k, v in r.obs_spans.items()
                if k.startswith("plan."))
    return total / 1e6 / rounds
