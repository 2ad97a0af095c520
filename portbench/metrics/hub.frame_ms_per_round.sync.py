"""Hub: milliseconds of the program's hub/frame spans (the outbound framing
inside SyncHub.flush: `split_outgoing`, one a (document, clock) group)
per round of the window."""


def read(r):
    rounds = len(r.seconds("round"))
    if "hub.frame" not in r.obs_spans or not rounds:
        return None
    return r.obs_seconds("hub.frame") * 1e3 / rounds
