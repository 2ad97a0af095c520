"""Backends behind the frontend↔backend protocol seam.

The names exported here are the host oracle facade's (``facade.py``), as
in the JAX package: ``Backend`` is ``facade.Backend``, and ``init``,
``apply_changes`` and the rest are the facade's functions. The public
API does not bind them: ``api.py`` binds ``backend.default``, the device
backend (``device.py``) on the CUDA card, and ``backend_for(device)``
gives that backend bound to another device (``"cpu"`` for the engines'
plain PyTorch versions). ``DeviceBackend``, ``DeviceBackendState``,
``backend_for`` and ``GRADUATION_STATS`` stay reachable here by name.
"""

from . import default  # noqa: F401
from . import facade  # noqa: F401
from .device import (  # noqa: F401
    GRADUATION_STATS, DeviceBackend, DeviceBackendState, backend_for,
)
from .facade import (  # noqa: F401
    Backend, BackendState, apply_changes, apply_local_change, get_changes,
    get_changes_for_actor, get_missing_changes, get_missing_deps, get_patch,
    init, merge,
)
