"""Service: milliseconds of the program's svc/admit spans (SyncService.tick's
admission loop over the tenants: each inbox against its budget, clock
reveals, the per-room groups) per round of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "svc.admit" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("svc.admit") * 1e3 / rounds
