"""Multi-tenant sync service tier (INTERNALS §13): the port of the JAX
package's ``service/``.

A tick-scheduled front end that multiplexes thousands of
``ResilientChannel`` tenant sessions over room-sharded ``SyncHub``s with
every resource explicitly bounded: per-tenant admission budgets enforced
as credit on the channel ack path, deadline-pressure shedding of the
lowest-priority work, a LIVE/SUSPECT/DEAD peer-health state machine whose
evictions reclaim hub + ClockMatrix + quarantine state, and snapshot-cache
join-storm coalescing for rejoins.

The rooms' documents live on ``ServiceConfig.device``: None (the
default) is the CUDA card, and without one the service raises at its
first room or lane — it never falls back; ``device="cpu"`` runs the
engines' plain PyTorch versions on the CPU.

Quickstart (in-process transport; see README "Running the sync service"):

    from automerge_tpu_torch.service import SyncService, ServiceConfig

    svc = SyncService(ServiceConfig(tick_budget_ms=5.0))
    svc.seed_doc("room-1", base_doc)
    sess = svc.connect("tenant-a", "room-1", send_raw=to_client_transport)
    ...                      # transport feeds frames to sess.on_wire
    svc.tick()               # one scheduler round (admission -> health
                             #  -> eviction -> one flush per room)
    print(svc.metrics())     # p99_tick_ms, shed_total, evictions, peaks,
                             #  max_lag_ops/ticks (INTERNALS §14.2)
    srv = svc.serve_metrics(port=9464)   # Prometheus /metrics + the
    print(svc.describe())    # black-box postmortem dump    # /describe
"""

from .budget import ServiceConfig, TenantBudget, approx_msg_bytes  # noqa: F401
from .server import DEAD, LIVE, SUSPECT, Room, SyncService, TenantSession  # noqa: F401,E501
