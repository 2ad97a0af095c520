"""Resilience layer: chaos transport, wire validation, quarantine, retry.

Four pieces, as in the JAX package's ``resilience``:

- ``errors`` / ``validation`` — typed :class:`ProtocolError` rejection of
  malformed wire messages and changes, shared by the sync tier (strict) and
  backend change application (lenient on unknown op actions, which keep
  flowing to the oracle's authoritative rejection via graduation);
  :class:`CheckpointError` is the checkpoint codec's typed rejection of a
  corrupt or truncated bundle.
- ``quarantine`` — bounded parking for causally-premature changes with
  eviction stats.
- ``inbound`` — the one validated + quarantined gate every remote delivery
  funnels through (cached per DocSet).
- ``chaos`` / ``channel`` — a deterministic seed-driven fault-injecting
  transport and the sequence/ack/retry layer that makes the unchanged
  ``{docId, clock, changes?}`` protocol survive it.

All of it runs on the host; the gate hands admitted deliveries to the
backend, whose engines run on the document's device.
"""

from .errors import CheckpointError, PeerDeadError, ProtocolError  # noqa: F401
from .validation import (  # noqa: F401
    prevalidated, validate_change, validate_changes, validate_clock,
    validate_msg, validate_op, validate_save_payload,
)
from .quarantine import DEFAULT_CAPACITY, QuarantineQueue  # noqa: F401
from .chaos import (  # noqa: F401
    WAN_PROFILES, ChaosLink, wan_pair, wan_profile,
)
from .channel import (  # noqa: F401
    ResilientChannel, payload_wire_bytes, validate_envelope,
)

# `inbound` resolves lazily (PEP 562): it imports the frontend, which is
# mid-initialization when backend/facade.py pulls in the validation layer
# during package import.
_LAZY = ("InboundGate", "inbound_gate")


def __getattr__(name):
    if name in _LAZY:
        from . import inbound
        return getattr(inbound, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
