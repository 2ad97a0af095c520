"""Hub: milliseconds of the program's hub/flush spans (SyncHub.flush: the
clock comparison over the room's peers, change extraction, framing and
the sends, once a room a tick) per round of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "hub.flush" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("hub.flush") * 1e3 / rounds
