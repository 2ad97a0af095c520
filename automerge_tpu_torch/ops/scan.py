"""Prefix-scan utilities: the tensor replacement for the skip list.

The reference maps elemId <-> visible index through an order-statistic
skip list. On a device the same queries are a prefix sum over visibility
flags in linearized order: `visible_index[i]` is the rank of element i
among visible elements — O(n) work, and it batches over whole documents.

The port of the JAX package's ``ops/scan.py``: plain PyTorch on the
caller's device. The engine's materialization computes the same ranks
through the segment-scan kernels (`scan_kernels.fused_segment_scans`);
these two functions are the standalone forms.
"""

from __future__ import annotations

import torch


def visible_index(pos: torch.Tensor, visible: torch.Tensor,
                  capacity: int | None = None):
    """Rank among visible elements, by linearized position.

    pos: element positions from rga_linearize (head=-1, padding large).
    visible: bool per element (has at least one surviving value op).
    Returns (vis_rank, n_visible) as int32 tensors on `pos`'s device:
    vis_rank[i] = index of element i in the user-facing list (only
    meaningful where visible[i]), n_visible = total (0-dim).
    """
    n = pos.shape[0]
    capacity = capacity or n
    # scatter visibility into position order, prefix-sum, gather back
    by_pos = torch.zeros(capacity + 1, dtype=torch.int32, device=pos.device)
    slot = pos.clamp(0, capacity).long()
    by_pos.index_add_(0, slot, visible.to(torch.int32))
    cum = torch.cumsum(by_pos, 0, dtype=torch.int32)
    # exclusive rank of the element at position p (clipped padding slots
    # can collide, but their ranks are never read)
    vis_rank = cum[slot] - by_pos[slot]
    n_visible = cum[capacity]
    return vis_rank, n_visible


def segment_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Boolean mask of group starts in a sorted key array."""
    head = torch.ones(1, dtype=torch.bool, device=sorted_keys.device)
    return torch.cat([head, sorted_keys[1:] != sorted_keys[:-1]])
