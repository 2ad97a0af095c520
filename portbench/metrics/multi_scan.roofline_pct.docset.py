"""Kernels: multi_scan's share of its roofline in the traced window
(portbench/roofline.py)."""

from portbench import roofline


def read(r):
    return roofline.multi_scan_share_pct(r)
