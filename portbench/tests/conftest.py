"""Shared helpers of the benchmark's tests: the checkout's root on the
path, and each cell of BENCHMARK.json cut to a size the CPU runs in a
second or two (the traffic's shapes as they are; only counts cut)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL_CONFIG = {"text_1m": {"base_len": 20000},
                "docset_1k": {"docs": 40, "doc_actors": 4, "doc_chars": 12,
                              "capacity": 64}}
SMALL_TRAFFIC = {
    "ring_backlog": {"actors": 40, "pairs": 50},
    "residual_backlog": {"actors": 100, "pairs": 40, "deletes": 10,
                         "bare_inserts": 10},
    "append_rounds": {},
    "batched_build": {},
}


def small_cell(name: str):
    """The cell as BENCHMARK.json names it, at a CPU test's size."""
    from portbench import spec
    c = spec.cell(name)
    c.config.update(SMALL_CONFIG[c.config["name"]])
    c.traffic.update(SMALL_TRAFFIC[name.split(".", 1)[1]])
    return c


def workload_names() -> list:
    import json
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def cuda_torch():
    """torch, where a CUDA card is present; skips otherwise."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch
