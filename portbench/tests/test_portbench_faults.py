"""The comparison fails where it must. Each test drives a whole run on the
CPU at a small size with the timed path broken underneath (a merge that
leaves the state unchanged, half of each batch left out, an answer
altered where it is produced) and sees `correct` come out false; and the
control, the reference in the program's place with one acknowledged
change left out of each session or round, fails too."""

import dataclasses
import time

import numpy as np
import pytest

from conftest import small_cell, workload_names
from portbench import control, harness

TEXT = ["text_1m.ring_backlog", "text_1m.residual_backlog"]
DOCSET = ["docset_1k.append_rounds", "docset_1k.batched_build"]


def half(b):
    """The batch less the second half of its changes."""
    n = b.n_changes // 2
    keep = b.op_change < n
    return dataclasses.replace(
        b, actors=b.actors[:n], seqs=b.seqs[:n], deps=b.deps[:n],
        messages=b.messages[:n],
        **{f: getattr(b, f)[keep] for f in (
            "op_change", "op_kind", "op_target_actor", "op_target_ctr",
            "op_parent_actor", "op_parent_ctr", "op_value")})


def run_broken(name):
    import torch
    from portbench import drive
    return harness.run_cell(drive.program(), torch, small_cell(name),
                            2**31 + 3, 0.4, False, torch.device("cpu"),
                            time.time_ns())


def _is_base(b):
    return list(b.actors) == ["base"]


@pytest.mark.parametrize("name", TEXT)
def test_text_merge_leaving_state_unchanged_fails(name, monkeypatch):
    from automerge_tpu_torch.engine import PipelinedIngestor
    from automerge_tpu_torch.engine.text_doc import DeviceTextDoc
    monkeypatch.setattr(PipelinedIngestor, "run",
                        lambda self, batches: self.doc)
    apply = DeviceTextDoc.apply_batch
    monkeypatch.setattr(DeviceTextDoc, "apply_batch", lambda self, b: (
        apply(self, b) if _is_base(b) else self))
    assert not run_broken(name)["correct"]


@pytest.mark.parametrize("name", TEXT)
def test_text_half_of_each_batch_left_out_fails(name, monkeypatch):
    from automerge_tpu_torch.engine.text_doc import DeviceTextDoc
    apply, prepare = DeviceTextDoc.apply_batch, DeviceTextDoc.prepare_batch
    monkeypatch.setattr(DeviceTextDoc, "apply_batch", lambda self, b: apply(
        self, b if _is_base(b) else half(b)))
    monkeypatch.setattr(DeviceTextDoc, "prepare_batch",
                        lambda self, b, **kw: prepare(self, half(b), **kw))
    assert not run_broken(name)["correct"]


@pytest.mark.parametrize("name", TEXT)
def test_text_altered_where_read_fails(name, monkeypatch):
    from automerge_tpu_torch.engine.text_doc import DeviceTextDoc
    text = DeviceTextDoc.text

    def altered(self):
        t = text(self)
        return ("b" if t[:1] != "b" else "c") + t[1:]
    monkeypatch.setattr(DeviceTextDoc, "text", altered)
    assert not run_broken(name)["correct"]


@pytest.mark.parametrize("name", DOCSET)
def test_docset_round_leaving_state_unchanged_fails(name, monkeypatch):
    from automerge_tpu_torch.engine import DeviceTextDocSet
    apply = DeviceTextDocSet.apply_batches
    calls = []

    def first_only(self, batches):
        calls.append(1)
        return apply(self, batches) if len(calls) == 1 else self
    monkeypatch.setattr(DeviceTextDocSet, "apply_batches", first_only)
    assert not run_broken(name)["correct"]


@pytest.mark.parametrize("name", DOCSET)
def test_docset_half_of_each_round_left_out_fails(name, monkeypatch):
    from automerge_tpu_torch.engine import DeviceTextDocSet
    apply = DeviceTextDocSet.apply_batches
    calls = []

    def halved(self, batches):
        calls.append(1)
        if len(calls) > 1:
            keys = sorted(batches)[: len(batches) // 2]
            batches = {k: batches[k] for k in keys}
        return apply(self, batches)
    monkeypatch.setattr(DeviceTextDocSet, "apply_batches", halved)
    assert not run_broken(name)["correct"]


@pytest.mark.parametrize("name", DOCSET)
def test_docset_altered_where_read_fails(name, monkeypatch):
    from automerge_tpu_torch.engine import DeviceTextDocSet
    texts = DeviceTextDocSet.texts

    def altered(self):
        out = texts(self)
        k = sorted(out)[-1]
        out[k] = "#" + out[k][1:]
        return out
    monkeypatch.setattr(DeviceTextDocSet, "texts", altered)
    assert not run_broken(name)["correct"]


@pytest.mark.parametrize("name", workload_names())
def test_control_fails(name):
    res = control.run_control(small_cell(name), 2**31 + 1, units=5)
    assert not res["correct"]
    assert res["failed"] >= 1


def test_half_keeps_a_consistent_batch():
    from portbench import drive
    from portbench.families import text_backlog
    c = small_cell("text_1m.residual_backlog")
    bl = text_backlog.backlog(c.config, c.traffic, 1)
    b = text_backlog.backlog_batch(drive.program(), "text", bl,
                                   bl.batches[0])
    h = half(b)
    assert h.n_changes == b.n_changes // 2
    assert np.all(h.op_change < h.n_changes)
