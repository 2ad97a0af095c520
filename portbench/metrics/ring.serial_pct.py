"""Share of the ring's committed batches that were not planned ahead:
(serial prepares + fallbacks) / committed, over the window's sessions
(PipelinedIngestor.stats)."""


def read(r):
    if not r.ring_stats:
        return None
    committed = sum(s["committed"] for s in r.ring_stats)
    slow = sum(s["serial_prepares"] + s["fallbacks"] for s in r.ring_stats)
    return 100.0 * slow / committed if committed else None
