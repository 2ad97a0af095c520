"""Resilience layer: typed rejection and schema validation of wire
messages, changes and save payloads.

``errors`` / ``validation`` — typed :class:`ProtocolError` rejection of
malformed wire messages and changes, shared by the backend's change
application (lenient on unknown op actions, which flow to the oracle's
authoritative rejection via graduation) and, once ported, the sync tier
(strict). The quarantine, inbound gate, chaos transport and retry channel
of the JAX package are not ported yet.
"""

from .errors import ProtocolError  # noqa: F401
from .validation import (  # noqa: F401
    prevalidated, validate_change, validate_changes, validate_clock,
    validate_msg, validate_op, validate_save_payload,
)
