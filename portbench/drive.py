"""The system under test and what every traffic family's runner shares.

A runner (one a family, `families/<family>.py`) turns its generated
traffic into the program's batches, sets up, and repeats its unit (a
session or a round) through the measured window. It keeps what the
window produced for the comparison with the reference, and the
benchmark-side spans (`spans`) and counters that the per-layer metrics
read. Only the timed path runs in the window: the reference runs after
it, on what the runner kept.
"""

from __future__ import annotations

import time

import numpy as np

now = time.perf_counter_ns
MASK64 = (1 << 64) - 1


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed; any whole number works as
    a seed (it is taken modulo 2**64)."""
    return np.random.default_rng([seed & MASK64, *stream])


def program():
    """The program's modules that the benchmark drives."""
    from types import SimpleNamespace

    from automerge_tpu_torch import _common, checkpoint, obs
    from automerge_tpu_torch.engine import (DeviceTextDocSet,
                                            PipelinedIngestor)
    from automerge_tpu_torch.engine.columnar import TextChangeBatch
    from automerge_tpu_torch.engine.text_doc import DeviceTextDoc
    from automerge_tpu_torch.ops import scan_kernels
    return SimpleNamespace(
        C=_common, ckpt=checkpoint, obs=obs, S=scan_kernels,
        TB=TextChangeBatch, DeviceTextDoc=DeviceTextDoc,
        DeviceTextDocSet=DeviceTextDocSet,
        PipelinedIngestor=PipelinedIngestor)


class Runner:
    """Spans, counters and the window loop. A family's runner adds
    `setup(seconds)`, `unit()`, `release()` (drops the program's state
    before the comparison) and `check()` -> ({name: (value, limit)},
    failed)."""

    def __init__(self, M, device, config: dict, traffic: dict, seed: int):
        self.M, self.device = M, device
        self.config, self.traffic, self.seed = config, traffic, seed
        self.spans: list = []        # (name, t0_ns, t1_ns)
        self.counters: dict = {}
        self.n_ops = 0               # ops completed in the window
        self.attempted = 0           # sessions or rounds in the window

    def span(self, name: str, t0: int, t1: int):
        self.spans.append((name, t0, t1))

    def sync(self):
        if self.device is not None and self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> tuple:
        """Run whole units until `seconds` have passed; returns the
        window's start and end (the end of its last unit) in
        perf_counter ns."""
        self.sync()
        t0 = now()
        end = t0 + int(seconds * 1e9)
        while True:
            self.unit()
            self.attempted += 1
            t = now()
            if t >= end:
                return t0, t
