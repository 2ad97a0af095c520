"""automerge_tpu_torch — the PyTorch/CUDA port of automerge_tpu.

The public API mirrors the JAX package's: ``init``, ``change``, ``merge``,
``apply_changes``, ``save``/``load`` and the rest, with ``Text``,
``Counter`` and ``Table`` values, over the frontend↔backend protocol seam.
By default a document lives on the CUDA card: its root map and every
nested map/table is a `DeviceMapDoc`, every text/list a `DeviceTextDoc`,
and multi-object rounds merge through `stacked.apply_stacked`
(backend/device.py). Without a card ``init()`` raises; pass
``{"backend": backend.backend_for("cpu")}`` to run the engines' plain
PyTorch versions on the CPU. Deliveries outside the device grammar
graduate to the host oracle (backend/facade.py). As in the JAX package,
``Backend`` and the names of the ``backend`` package are the oracle
facade's; the API binds ``backend.default``, the device backend.

Checkpoints: ``checkpoint_doc(doc)`` captures a document's lineage into
an ``AMTPUCKPT1`` bundle (a `Checkpoint`), ``restore(ck, options)``
rebuilds the document from it without replaying its history, on the
device of the backend `options` name, and ``save(doc, checkpoint=ck)`` /
``load(delta, checkpoint=ck)`` write and read delta saves. A corrupt
bundle raises `CheckpointError`. `AsyncCheckpointer` captures engine
documents and backend states on a worker thread (checkpoint/).

The engines are public too: `DeviceTextDoc(obj_id, capacity=1024,
device=None)` keeps one text/list object's element tables on the card
(``device=None``) or, when asked with ``device="cpu"``, on the CPU;
`DeviceMapDoc` does the same for a map/counter object, and
`PipelinedIngestor(doc, donate=True)` streams batches into a text
document through a K-deep prepare/commit ring with in-place commits.
`stacked.apply_stacked(items)` merges one round of many small map and
text documents as one round program per causal round, and
`DeviceTextDocSet(obj_ids)` keeps a set of text documents in stacked
(docs, capacity) tables. The round programs are plain PyTorch around two
hand-written Hopper kernels (ops/scan_kernels.py, csrc/scan.cu); on a CPU
tensor each kernel's plain PyTorch version runs instead. Host decoding and
run detection run in a C++ codec built with g++ at first use (native/).
The package imports torch and numpy, never JAX.
"""

from . import backend  # noqa: F401
from . import frontend  # noqa: F401
from . import resilience  # noqa: F401
from . import types  # noqa: F401
from ._common import ROOT_ID  # noqa: F401
from ._uuid import uuid  # noqa: F401
from .api import (  # noqa: F401
    apply_changes, change, diff, empty_change, equals, from_,
    get_all_changes, get_changes, get_history, get_missing_deps, init, load,
    merge, redo, restore, save, to_json, undo,
)
from .backend import Backend  # noqa: F401
from . import checkpoint  # noqa: F401
from .checkpoint import (  # noqa: F401
    AsyncCheckpointer, Checkpoint, checkpoint_doc,
)
from .engine import (DeviceMapDoc, DeviceTextDoc,  # noqa: F401
                     DeviceTextDocSet, MapChangeBatch, PipelinedIngestor,
                     TextChangeBatch, stacked)
from .frontend import (  # noqa: F401
    Counter, Frontend, Table, Text, can_redo, can_undo, get_actor_id,
    get_conflicts, get_object_by_id, get_object_id, set_actor_id,
)
from .resilience import CheckpointError, ProtocolError  # noqa: F401

__version__ = "0.1.0"
