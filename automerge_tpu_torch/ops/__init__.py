"""Device kernels and tensor programs of the PyTorch text engine."""

from .linearize import rga_linearize  # noqa: F401
from .scan import segment_starts, visible_index  # noqa: F401
from .scan_kernels import fused_segment_scans, multi_scan  # noqa: F401
