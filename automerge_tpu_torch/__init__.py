"""automerge_tpu_torch — the PyTorch/CUDA port of the automerge_tpu
document engines.

`DeviceTextDoc(obj_id, capacity=1024, device=None)` keeps one text/list
object's element tables on a CUDA card (``device=None``) or, when asked
with ``device="cpu"``, on the CPU; `DeviceMapDoc` does the same for a
map/counter object, and `PipelinedIngestor(doc, donate=True)` streams
batches into a text document through a K-deep prepare/commit ring with
in-place commits. `stacked.apply_stacked(items)` merges one round of many
small map and text documents as one round program per causal round, and
`DeviceTextDocSet(obj_ids)` keeps a set of text documents in stacked
(docs, capacity) tables. The round programs are plain PyTorch around two
hand-written Hopper kernels (ops/scan_kernels.py, csrc/scan.cu); on a CPU
tensor each kernel's plain PyTorch version runs instead. Host decoding and
run detection run in a C++ codec built with g++ at first use (native/).
The package imports torch and numpy, never JAX.
"""

from .engine import (DeviceMapDoc, DeviceTextDoc,  # noqa: F401
                     DeviceTextDocSet, MapChangeBatch, PipelinedIngestor,
                     TextChangeBatch, stacked)
