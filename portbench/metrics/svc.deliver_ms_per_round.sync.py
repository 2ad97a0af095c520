"""Service: milliseconds of the program's svc/deliver spans (SyncService.tick's
grouped deliveries: one InboundGate delivery a room, its device backend
apply, the frontend patch) per round of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "svc.deliver" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("svc.deliver") * 1e3 / rounds
