"""Multi-device execution over a (doc, elem) mesh of devices
(parallel/mesh.py): the counterpart of `automerge_tpu/parallel`."""

from .mesh import (Mesh, ShardedArray, batched_merge_step,  # noqa: F401
                   make_mesh, sharded_merge_step,
                   sharded_planned_materialize)
