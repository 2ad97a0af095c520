"""Backends behind the frontend↔backend protocol seam.

``device`` serves documents from the port's engines (``DeviceBackend``
on the CUDA card, ``backend_for(device)`` on another device); ``facade``
is the host oracle (``facade.Backend``), the semantic judge that
graduated lineages move to. The names exported here are the device
backend's: each entry dispatches on the state it is given, so oracle
states pass through to the oracle.
"""

from . import facade  # noqa: F401
from .default import (  # noqa: F401
    Backend, apply_changes, apply_local_change, backend_for, get_changes,
    get_changes_for_actor, get_missing_changes, get_missing_deps, get_patch,
    init, merge, redo, undo,
)
from .device import (  # noqa: F401
    GRADUATION_STATS, DeviceBackend, DeviceBackendState,
)
from .facade import BackendState  # noqa: F401
