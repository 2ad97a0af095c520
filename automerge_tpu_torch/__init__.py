"""automerge_tpu_torch — the PyTorch/CUDA port of the automerge_tpu text
engine.

`DeviceTextDoc(obj_id, capacity=1024, device=None)` keeps one text/list
object's element tables on a CUDA card (``device=None``) or, when asked
with ``device="cpu"``, on the CPU. The round programs are plain PyTorch
around two hand-written Hopper kernels (ops/scan_kernels.py,
csrc/scan.cu); on a CPU tensor each kernel's plain PyTorch version runs
instead. The package imports torch and numpy, never JAX.
"""

from .engine import DeviceTextDoc, TextChangeBatch  # noqa: F401
