"""Default backend binding for the public API: the device-engine backend
(``device.py``) on the CUDA card. Document trees ride the port's engines;
a delivery outside the device grammar graduates to the oracle. The oracle
stays reachable by name (``backend.facade.Backend``), and
``backend_for(device)`` binds the device backend to another device
(``"cpu"`` for the engines' plain PyTorch versions). No environment
variable selects the binding.
"""

from . import device as _impl

init = _impl.init
apply_changes = _impl.apply_changes
apply_local_change = _impl.apply_local_change
get_patch = _impl.get_patch
get_changes = _impl.get_changes
get_changes_for_actor = _impl.get_changes_for_actor
get_missing_changes = _impl.get_missing_changes
get_missing_deps = _impl.get_missing_deps
merge = _impl.merge
undo = _impl.undo
redo = _impl.redo
Backend = _impl.Backend
backend_for = _impl.backend_for
