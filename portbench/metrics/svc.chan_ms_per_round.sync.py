"""Service: milliseconds of the program's svc/chan spans (SyncService.tick's
retransmission timers of every tenant channel, the peer-health pass and
the evictions) per round of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "svc.chan" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("svc.chan") * 1e3 / rounds
