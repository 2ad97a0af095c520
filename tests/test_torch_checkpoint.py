"""The port's checkpoint tier (automerge_tpu_torch/checkpoint/) against
the JAX package's, on the CPU.

The same seeded inputs go through both packages: the JAX package on its
default backend and engines, the port on `backend.backend_for("cpu")` and
`device="cpu"`. Tolerance is zero: bundles and saves are compared byte
for byte, texts, patches, clocks and tables exactly.

- Twins of tests/test_checkpoint.py: the save/load and restore
  equivalence properties, delta saves, corruption, the engine restore
  (conflicts, the queued-change refusal), the async writer (identity,
  conflict degradation, the pipeline prefix), the load payload errors and
  the grab races; the donation twin of tests/test_pipeline.py
  `test_donation_refuses_deferred_checkpoint_grab`.
- Cross-package identity: engine bundles (text and map) and backend
  bundles (text, map, graduated) are byte-identical, and each package
  restores the other's; a JAX bundle restored by the port equals the
  `state.py` carry of the same JAX document.
- The torch-specific trap: an in-place session since a grab makes the
  cached snapshot unservable (tensor version counters).
- Twins of tests/test_failure_atomicity.py's contracts next to restore: a
  failing batch leaves the prior state usable, a failed restore leaves no
  state.
- On a card only (`cuda` marker): the async writer's worker-thread d2h
  waits for the kernels that produced the grabbed tables.

Deferred, with the JAX tests they twin: the snapshot-bootstrapped sync
tests (tests/test_checkpoint.py `test_corrupt_bundle_falls_back_to_full_
replay`'s DocSet half and the three `test_sync_snapshot_*` tests) need
the port's `sync/` tier; the soak and bench drivers
(`test_soak_checkpoint_profile_session`,
`test_bench_restore_metrics_small_scale`) drive the JAX package's own
scripts — `test_restore_metrics_small_scale_equivalence` below is the
port's small-scale restore equivalence in their place.
"""

import itertools
import json
import threading
import time

import numpy as np
import pytest
import torch

import automerge_tpu as J
import automerge_tpu_torch as T
import bench as B
from automerge_tpu import _uuid as j_uuid
from automerge_tpu import checkpoint as JC
from automerge_tpu.backend import device as j_device
from automerge_tpu.engine import DeviceMapDoc as JMap
from automerge_tpu.engine import DeviceTextDoc as JDoc
from automerge_tpu.engine.columnar import TextChangeBatch as JB
from automerge_tpu_torch import _uuid as t_uuid
from automerge_tpu_torch import checkpoint as TC
from automerge_tpu_torch import state as S
from automerge_tpu_torch.checkpoint import bundle as t_bundle
from automerge_tpu_torch.checkpoint.engine_codec import CaptureConflict, grab
from automerge_tpu_torch.engine import DeviceMapDoc as TMap
from automerge_tpu_torch.engine import DeviceTextDoc as TDoc
from automerge_tpu_torch.engine import PipelinedIngestor
from automerge_tpu_torch.engine import TextChangeBatch as TBatch
from automerge_tpu_torch.resilience import CheckpointError, ProtocolError

CPU = T.backend.backend_for("cpu")
KEYS = TDoc._TABLE_KEYS


@pytest.fixture(autouse=True)
def pinned_uuids():
    for m in (j_uuid, t_uuid):
        c = itertools.count(1)
        m.set_factory(lambda c=c: f"00000000-0000-0000-0000-{next(c):012d}")
    yield
    j_uuid.reset()
    t_uuid.reset()


def opts(am, actor):
    return actor if am is J else {"actorId": actor, "backend": CPU}


def where(am, actor=None):
    """The options a restore or load of `am` takes (the port: the CPU).
    A document that goes on editing gets an explicit actor: the two
    packages draw on their uuid factories at different points."""
    if am is J:
        return actor
    return {"backend": CPU, **({"actorId": actor} if actor else {})}


def canon(am, doc) -> str:
    return json.dumps(am.to_json(doc), sort_keys=True, default=str)


def as_port(batch):
    return TBatch(**{k: getattr(batch, k)
                     for k in batch.__dataclass_fields__})


# --------------------------------------------------------------------------
# documents grown through the public API, identically in both packages
# --------------------------------------------------------------------------


def random_history_doc(am, seed: int):
    """A doc grown through seeded random merge/undo/delete interleavings
    (tests/test_checkpoint.py `random_history_doc`, on either package)."""
    rng = np.random.default_rng(seed)
    base = am.change(am.init(opts(am, "base")), lambda d: (
        d.__setitem__("t", am.Text("seed")),
        d.__setitem__("m", {"k": 0})))
    changes = am.get_all_changes(base)
    peers = [am.apply_changes(am.init(opts(am, f"p{i}")), changes)
             for i in range(3)]
    for _ in range(int(rng.integers(10, 20))):
        i = int(rng.integers(0, len(peers)))
        act = int(rng.integers(0, 6))
        if act == 0:
            k = f"k{int(rng.integers(0, 4))}"
            v = int(rng.integers(-99, 99))
            peers[i] = am.change(peers[i],
                                 lambda d, k=k, v=v: d.__setitem__(k, v))
        elif act == 1:
            def edit(d):
                t = d["t"]
                if len(t) and rng.integers(0, 3) == 0:
                    t.delete_at(int(rng.integers(0, len(t))))
                else:
                    t.insert_at(int(rng.integers(0, len(t) + 1)),
                                chr(97 + int(rng.integers(0, 26))))
            peers[i] = am.change(peers[i], edit)
        elif act == 2 and am.can_undo(peers[i]):
            peers[i] = am.undo(peers[i])
        elif act == 3 and am.can_redo(peers[i]):
            peers[i] = am.redo(peers[i])
        else:
            j = int(rng.integers(0, len(peers)))
            if j != i:
                peers[i] = am.merge(peers[i], peers[j])
    for _ in range(2):
        for i in range(len(peers)):
            for j in range(len(peers)):
                if i != j:
                    peers[i] = am.merge(peers[i], peers[j])
    return peers[0]


def oracle_doc(am, changes):
    """The same history replayed through the package's host oracle (the
    port's `backend.Backend` is the oracle facade, as the JAX package's)."""
    oracle = am.backend.Backend
    return am.apply_changes(am.init({"actorId": "o", "backend": oracle}),
                            changes)


@pytest.mark.parametrize("seed", range(6))
def test_save_load_matches_oracle_property(seed):
    out = {}
    for am in (J, T):
        doc = random_history_doc(am, seed)
        back = am.load(am.save(doc), where(am))
        odoc = oracle_doc(am, am.get_all_changes(doc))
        assert canon(am, back) == canon(am, odoc) == canon(am, doc)
        out[am] = (canon(am, doc), am.save(doc), am.save(back))
    assert out[T] == out[J]


@pytest.mark.parametrize("seed", range(4))
def test_checkpoint_restore_equivalence_property(seed):
    out = {}
    for am in (J, T):
        doc = random_history_doc(am, seed)
        ck = am.checkpoint_doc(doc)
        back = am.restore(ck, where(am, "restored"))
        assert canon(am, back) == canon(am, doc)
        # history-complete: the restored doc re-serializes byte-for-byte
        assert am.save(back) == am.save(doc)
        # and keeps syncing: diverge both sides, then re-merge
        back = am.change(back, lambda d: d.__setitem__("after", 1))
        doc = am.change(doc, lambda d: d["t"].insert_at(0, "Q"))
        doc = am.merge(doc, back)
        back = am.merge(back, doc)
        assert canon(am, back) == canon(am, doc)
        out[am] = (ck.data, canon(am, back), am.save(doc))
    assert out[T] == out[J]      # the bundles too, byte for byte


def test_restores_default_to_the_card():
    """Entry points run on the card unless the caller names the CPU: a
    restore with no options (or the default namespace) binds the card,
    and without one raises the engine's error — never the CPU."""
    ck = T.checkpoint_doc(_doc_with_history())
    assert T.backend.DeviceBackend.device is None
    assert CPU.device == "cpu"
    if torch.cuda.is_available():
        back = T.restore(ck)
        core = T.frontend.get_backend_state(back)._core
        assert core.device.type == "cuda"
        return
    for call in (lambda: T.restore(ck), lambda: T.restore(ck, "actor"),
                 lambda: TC.restore_state(ck.data),
                 lambda: T.restore(ck, {"backend": T.backend.DeviceBackend})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_restore_drops_undo_history_like_load():
    doc = T.change(T.init(opts(T, "u")), lambda d: d.__setitem__("x", 1))
    assert T.can_undo(doc)
    assert not T.can_undo(T.restore(T.checkpoint_doc(doc), where(T)))
    assert not T.can_undo(T.load(T.save(doc), where(T)))


def _delta_session(am):
    doc = am.change(am.init(opts(am, "alice")),
                    lambda d: d.__setitem__("t", am.Text("hello")))
    for i in range(5):
        doc = am.change(doc, lambda d, i=i: d["t"].insert_at(0, str(i)))
    ck = am.checkpoint_doc(doc)
    tail_start = doc
    for i in range(3):
        doc = am.change(doc, lambda d, i=i: d["t"].insert_at(0, chr(65 + i)))
    return doc, tail_start, ck


def test_delta_save_tail_replay():
    out = {}
    for am in (J, T):
        doc, tail_start, ck = _delta_session(am)
        delta = am.save(doc, checkpoint=ck)
        payload = json.loads(delta)
        assert payload["format"] == "automerge-tpu-delta-v1"
        assert payload["checkpointId"] == ck.id
        # compaction: only the tail past the frontier rides in the save
        assert len(payload["changes"]) == 3
        assert len(delta) < len(am.save(doc))
        back = am.load(delta, where(am), checkpoint=ck)
        assert canon(am, back) == canon(am, doc)
        # the frontier state itself round-trips with an empty tail
        empty_delta = am.save(tail_start, checkpoint=ck)
        assert json.loads(empty_delta)["changes"] == []
        assert canon(am, am.load(empty_delta, where(am), checkpoint=ck)) \
            == canon(am, tail_start)
        out[am] = (ck.data, delta, empty_delta, am.save(back))
    assert out[T] == out[J]


def test_delta_load_requires_checkpoint():
    doc = T.change(T.init(opts(T, "a")), lambda d: d.__setitem__("x", 1))
    ck = T.checkpoint_doc(doc)
    doc = T.change(doc, lambda d: d.__setitem__("y", 2))
    delta = T.save(doc, checkpoint=ck)
    with pytest.raises(ValueError, match="delta-compacted"):
        T.load(delta, where(T))
    # a different checkpoint is rejected by id before any restore work
    other = T.checkpoint_doc(T.change(T.init(opts(T, "b")),
                                      lambda d: d.__setitem__("z", 9)))
    with pytest.raises(CheckpointError, match="wrong base checkpoint"):
        T.load(delta, where(T), checkpoint=other)


def test_delta_save_rejects_non_ancestor():
    doc = T.change(T.init(opts(T, "a")), lambda d: d.__setitem__("x", 1))
    ck = T.checkpoint_doc(T.change(doc, lambda d: d.__setitem__("y", 2)))
    with pytest.raises(ValueError, match="not an ancestor"):
        T.save(doc, checkpoint=ck)   # doc is BEHIND the checkpoint


# --------------------------------------------------------------------------
# integrity / fallback
# --------------------------------------------------------------------------


def _doc_with_history(am=T):
    doc = am.change(am.init(opts(am, "alice")),
                    lambda d: d.__setitem__("t", am.Text("integrity")))
    doc = am.change(doc, lambda d: d.__setitem__("m", {"k": [1, 2]}))
    doc = am.change(doc, lambda d: d["t"].delete_at(0))
    return doc


def test_truncated_bundle_raises_checkpoint_error():
    ck = T.checkpoint_doc(_doc_with_history())
    for cut in (10, 50, len(ck.data) // 2, len(ck.data) - 3):
        with pytest.raises(CheckpointError):
            TC.restore_state(ck.data[:cut], "cpu")


def test_bit_flipped_bundle_raises_checkpoint_error():
    ck = T.checkpoint_doc(_doc_with_history())
    n = len(ck.data)
    # flip bytes across the whole bundle: header, manifest, array blobs
    for pos in (2, n // 4, n // 2, (3 * n) // 4, n - 10):
        data = bytearray(ck.data)
        data[pos] ^= 0x40
        with pytest.raises(CheckpointError):
            TC.restore_state(bytes(data), "cpu")


def test_manifest_bit_flip_raises_checkpoint_error():
    # a flip that keeps the manifest JSON parseable (a clock digit) must
    # still fail the header hash, never restore silently
    ck = T.checkpoint_doc(_doc_with_history())
    hdr = len(t_bundle.MAGIC) + 8 + 32
    data = bytearray(ck.data)
    pos = ck.data.index(b'"clock"', hdr) + len(b'"clock"') + 12
    data[pos] ^= 0x01
    with pytest.raises(CheckpointError, match="manifest"):
        TC.restore_state(bytes(data), "cpu")
    with pytest.raises(CheckpointError):
        TC.Checkpoint(bytes(data)).clock   # peek is hash-verified too


def test_corrupt_bundle_falls_back_to_full_replay():
    doc = _doc_with_history()
    ck = T.checkpoint_doc(doc)
    corrupt = bytearray(ck.data)
    corrupt[len(corrupt) // 2] ^= 0xFF
    with pytest.raises(CheckpointError):
        TC.restore_doc(bytes(corrupt), where(T))
    # with the full log, restore degrades to replay and still lands
    out = TC.restore_doc_or_replay(bytes(corrupt), T.get_all_changes(doc),
                                   where(T))
    assert canon(T, out) == canon(T, doc)
    assert T.save(out) == T.save(doc)
    state = TC.restore_state_or_replay(bytes(corrupt),
                                       T.get_all_changes(doc), "cpu")
    assert state._core.device.type == "cpu"


def test_bundle_module_is_byte_identical_to_the_jax_package():
    """The container of both packages: one encode, one hash scheme."""
    from automerge_tpu.checkpoint import bundle as j_bundle
    rng = np.random.default_rng(5)
    arrays = {"a": rng.integers(-9, 9, 17).astype(np.int32),
              "b": rng.integers(0, 2, 9).astype(bool),
              "c": np.arange(4, dtype=np.int64),
              "h": t_bundle.json_array([{"z": 1, "a": [2, "x"]}])}
    man = {"engine": "x", "clock": {"b": 2, "a": 1}}
    data = t_bundle.encode(man, arrays)
    assert data == j_bundle.encode(man, arrays)
    assert t_bundle.bundle_id(data) == j_bundle.bundle_id(data)
    m1, a1 = t_bundle.decode(data)
    m2, a2 = j_bundle.decode(data)
    assert m1 == m2 and a1.keys() == a2.keys()
    for k in a1:
        assert a1[k].dtype == a2[k].dtype
        np.testing.assert_array_equal(a1[k], a2[k])


# --------------------------------------------------------------------------
# engine level (the bench seam)
# --------------------------------------------------------------------------


def _engine_text_docs(n=400):
    """The same text doc on both engines."""
    docs = []
    for cls in (JDoc, TDoc):
        doc = cls("t") if cls is JDoc else cls("t", device="cpu")
        for b in (B.base_batch("t", n), B.merge_batch("t", 6, 50, n, seed=2)):
            doc.apply_batch(b if cls is JDoc else as_port(b))
        docs.append(doc)
    return docs, n


def _port_text_doc(n=400):
    return _engine_text_docs(n)[0][1], n


def test_engine_restore_equivalence_and_tail_replay():
    (jdoc, doc), n = _engine_text_docs()
    data = TC.capture_engine(doc)
    assert data == JC.capture_engine(jdoc)
    d2 = TC.restore_engine(data, "cpu")
    assert d2.device.type == "cpu"
    assert d2.text() == doc.text() == jdoc.text()
    assert d2.elem_ids() == doc.elem_ids()
    # tail replay lands identically on original and restored
    tail = B.merge_batch("t", 4, 30, n, seed=7, actor_prefix="tl")
    doc.apply_batch(as_port(tail))
    d2.apply_batch(as_port(tail))
    jdoc.apply_batch(tail)
    assert d2.text() == doc.text() == jdoc.text()
    assert d2.elem_ids() == doc.elem_ids()
    assert dict(d2.clock) == dict(doc.clock)
    assert TC.capture_engine(d2) == JC.capture_engine(jdoc)


def _conflict_changes():
    def mk(a, key, parent, val, deps):
        return {"actor": a, "seq": 1, "deps": deps, "ops": [
            {"action": "ins", "obj": "t", "key": parent, "elem": 1},
            {"action": "set", "obj": "t", "key": key, "value": val}]}
    return [[mk("base", "base:1", "_head", "x", {})], [
        {"actor": "a", "seq": 1, "deps": {"base": 1}, "ops": [
            {"action": "set", "obj": "t", "key": "base:1", "value": "A"}]},
        {"actor": "b", "seq": 1, "deps": {"base": 1}, "ops": [
            {"action": "set", "obj": "t", "key": "base:1", "value": "B"}]},
    ]]


def test_engine_restore_preserves_conflict_registers():
    doc, jdoc = TDoc("t", device="cpu"), JDoc("t")
    for chs in _conflict_changes():
        doc.apply_changes(chs)
        jdoc.apply_changes(chs)
    assert doc.conflicts_at(0) is not None
    data = TC.capture_engine(doc)
    assert data == JC.capture_engine(jdoc)
    d2 = TC.restore_engine(data, "cpu")
    assert d2.text() == doc.text()
    assert d2.conflicts_at(0) == doc.conflicts_at(0) == jdoc.conflicts_at(0)


def test_engine_capture_rejects_queued_changes():
    doc = TDoc("t", device="cpu")
    doc.apply_changes([{"actor": "a", "seq": 2, "deps": {}, "ops": [
        {"action": "ins", "obj": "t", "key": "_head", "elem": 1},
        {"action": "set", "obj": "t", "key": "a:1", "value": "x"}]}])
    assert doc.queue   # causally premature: parked in the engine queue
    with pytest.raises(CheckpointError, match="queued"):
        TC.capture_engine(doc)


def test_engine_restore_meters_the_staged_bytes():
    """Restore is one h2d staging pass of the padded tables, metered
    exactly (the default device is the card: without one it raises)."""
    from automerge_tpu_torch.engine import accounting
    from automerge_tpu_torch.ops.ingest import bucket
    doc, n = _port_text_doc()
    data = TC.capture_engine(doc)
    with accounting.track() as t:
        d2 = TC.restore_engine(data, "cpu")
    cap = bucket(d2.n_elems + 1)
    assert t.stats["h2d_bytes"] == cap * (6 * 4 + 3 * 1)
    assert d2.dispatch_stats["h2d_bytes"] == cap * 27
    assert d2.seg_mirror is not None and d2._cap == cap
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.restore_engine(data)


# --------------------------------------------------------------------------
# cross-package identity
# --------------------------------------------------------------------------


def _map_changes():
    return [
        {"actor": "a", "seq": 1, "deps": {}, "ops": [
            {"action": "set", "obj": "m", "key": f"k{i}", "value": i}
            for i in range(40)]},
        {"actor": "b", "seq": 1, "deps": {"a": 1}, "ops": [
            {"action": "set", "obj": "m", "key": "k3", "value": "bee"},
            {"action": "del", "obj": "m", "key": "k4"}]},
        {"actor": "c", "seq": 1, "deps": {"a": 1}, "ops": [
            {"action": "set", "obj": "m", "key": "k3", "value": "sea"},
            {"action": "set", "obj": "m", "key": "n", "value": 7,
             "datatype": "counter"}]},
        {"actor": "c", "seq": 2, "deps": {}, "ops": [
            {"action": "inc", "obj": "m", "key": "n", "value": 5}]},
    ]


def test_engine_map_bundles_identical_both_directions():
    jm, tm = JMap("m"), TMap("m", device="cpu")
    jm.apply_changes(_map_changes())
    tm.apply_changes(_map_changes())
    jdata, tdata = JC.capture_engine(jm), TC.capture_engine(tm)
    assert tdata == jdata
    in_port = TC.restore_engine(jdata, "cpu")
    in_jax = JC.restore_engine(tdata)
    assert in_port.to_dict() == tm.to_dict() == in_jax.to_dict()
    assert in_port.conflicts_for("k3") == tm.conflicts_for("k3")
    assert TC.capture_engine(in_port) == JC.capture_engine(in_jax) == jdata


def test_engine_text_bundles_restore_across_packages():
    (jdoc, doc), _ = _engine_text_docs(600)
    jdata, tdata = JC.capture_engine(jdoc), TC.capture_engine(doc)
    assert tdata == jdata
    assert JC.restore_engine(tdata).text() == doc.text()
    assert TC.restore_engine(jdata, "cpu").text() == jdoc.text()


def test_jax_engine_bundle_restore_equals_state_carry():
    """A JAX bundle restored by the port and the `state.py` carry of the
    same JAX document agree: live tables, index rows, clock, closures,
    conflicts and text."""
    jdoc = JDoc("t")
    for chs in _conflict_changes():
        jdoc.apply_changes(chs)
    jdoc.apply_batch(B.merge_batch("t", 5, 20, 1, seed=3))
    via_bundle = TC.restore_engine(JC.capture_engine(jdoc), "cpu")
    via_state = S.load_text_doc_state(TDoc("t", device="cpu"),
                                      S.host_state(jdoc))
    live = jdoc.n_elems + 1
    for k in KEYS:
        a = via_bundle._ensure_dev()[k][:live].numpy()
        b = via_state._ensure_dev()[k][:live].numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for a, b in zip(via_bundle.index.rows(), via_state.index.rows()):
        np.testing.assert_array_equal(a, b)
    assert via_bundle.clock == via_state.clock == jdoc.clock
    assert via_bundle._all_deps == via_state._all_deps
    assert via_bundle.conflicts == via_state.conflicts
    assert via_bundle.text() == via_state.text() == jdoc.text()

    jm = JMap("m")
    jm.apply_changes(_map_changes())
    m_bundle = TC.restore_engine(JC.capture_engine(jm), "cpu")
    m_state = S.load_map_doc_state(TMap("m", device="cpu"), S.map_state(jm))
    for k in m_bundle._ensure_dev():
        n = len(jm.key_table)
        np.testing.assert_array_equal(m_bundle._dev[k][:n].numpy(),
                                      m_state._ensure_dev()[k][:n].numpy())
    assert m_bundle.to_dict() == m_state.to_dict() == jm.to_dict()
    assert m_bundle.conflicts == m_state.conflicts


def _backend_lineage(am, kind):
    doc = am.change(am.init(opts(am, "carry")), lambda d: d.update(
        {"t": am.Text("abcdef"), "m": {"k": 1}, "c": am.Counter(2)}))
    doc = am.change(doc, lambda d: d["t"].insert_at(3, *"XY"))
    peer = am.change(am.merge(am.init(opts(am, "peer")), doc),
                     lambda d: (d["t"].delete_at(0),
                                d["m"].__setitem__("k", 9)))
    doc = am.change(doc, lambda d: d["m"].__setitem__("k", 2))
    doc = am.merge(doc, peer)
    if kind == "map":
        doc = am.change(doc, lambda d: d.__setitem__("rows", {"r": [1]}))
    return doc


def _graduated_state(am):
    """A lineage graduated to the oracle by one delivery outside the
    device grammar (an `ins` on a map object), at the backend level."""
    doc = _backend_lineage(am, "text")
    state = am.frontend.get_backend_state(doc)
    bad = {"actor": "zed", "seq": 1, "deps": {}, "ops": [
        {"action": "ins", "obj": am.get_object_id(doc["m"]),
         "key": "_head", "elem": 1}]}
    dev = j_device if am is J else T.backend.device
    state, _ = dev.apply_changes(state, [bad])
    assert type(state).__name__ == "BackendState"
    return state


@pytest.mark.parametrize("kind", ["text", "map"])
def test_backend_bundles_identical_both_directions(kind):
    jd, td = _backend_lineage(J, kind), _backend_lineage(T, kind)
    jck, tck = J.checkpoint_doc(jd), T.checkpoint_doc(td)
    assert tck.data == jck.data
    assert t_bundle.peek(tck.data)["engine"] == "device"
    in_port = T.restore(jck.data, where(T, "r"))
    in_jax = J.restore(tck.data, "r")
    assert T.save(in_port) == J.save(in_jax) == J.save(jd)
    assert canon(T, in_port) == canon(J, in_jax) == canon(J, jd)
    assert T.frontend.get_backend_state(in_port).clock == \
        J.frontend.get_backend_state(jd).clock
    # the restored lineages take the same next change alike
    in_port = T.change(in_port, lambda d: d.__setitem__("next", 1))
    in_jax = J.change(in_jax, lambda d: d.__setitem__("next", 1))
    assert T.save(in_port) == J.save(in_jax)


def test_graduated_backend_bundles_identical_both_directions():
    from automerge_tpu.backend import facade as j_facade
    jstate, tstate = _graduated_state(J), _graduated_state(T)
    jdata, tdata = JC.capture_state(jstate), TC.capture_state(tstate)
    assert tdata == jdata
    assert t_bundle.peek(tdata)["engine"] == "oracle"
    in_port = TC.restore_state(jdata, "cpu")
    in_jax = JC.restore_state(tdata)
    assert in_port.history() == in_jax.history() == jstate.history()
    assert in_port.clock == in_jax.clock == jstate.clock
    assert T.backend.facade.get_patch(in_port)["diffs"] == \
        j_facade.get_patch(in_jax)["diffs"]
    assert TC.capture_state(in_port) == JC.capture_state(in_jax)


@pytest.mark.parametrize("graduated", [False, True])
def test_jax_backend_bundle_restore_equals_state_carry(graduated):
    if graduated:
        jstate = _graduated_state(J)
    else:
        jstate = J.frontend.get_backend_state(_backend_lineage(J, "text"))
    via_bundle = TC.restore_state(JC.capture_state(jstate), "cpu")
    via_state = S.backend_state_from_jax(jstate, "cpu")
    mod = T.backend.facade if graduated else T.backend.device
    assert type(via_bundle) is type(via_state)
    assert via_bundle.clock == via_state.clock == jstate.clock
    assert via_bundle.deps == via_state.deps
    assert via_bundle.history() == via_state.history()
    assert mod.get_patch(via_bundle)["diffs"] == \
        mod.get_patch(via_state)["diffs"]
    assert TC.capture_state(via_bundle) == JC.capture_state(jstate)


# --------------------------------------------------------------------------
# async writer
# --------------------------------------------------------------------------


def test_async_capture_identity_engine_doc():
    doc, _ = _port_text_doc(200)
    with TC.AsyncCheckpointer() as w:
        h = w.capture_async(doc)
        sync_bytes = TC.AsyncCheckpointer.capture(doc)
        assert h.result(30) == sync_bytes
        assert w.stats["async_captures"] == 1
        assert w.stats["sync_fallbacks"] == 0
    assert TC.restore_engine(sync_bytes, "cpu").text() == doc.text()


def test_async_capture_identity_backend_state():
    state = T.frontend.get_backend_state(_doc_with_history())
    with TC.AsyncCheckpointer() as w:
        h = w.capture_async(state)
        assert h.result(30) == TC.capture_state(state)
    jstate = J.frontend.get_backend_state(_doc_with_history(J))
    assert TC.capture_state(state) == JC.capture_state(jstate)


def test_async_capture_conflict_degrades_to_sync():
    doc, _ = _port_text_doc(200)
    doc._busy = 1   # simulate a mutation permanently in flight
    with TC.AsyncCheckpointer(max_grab_retries=2) as w:
        h = w.capture_async(doc)
        h._done.wait(30)
        assert w.stats["sync_fallbacks"] == 1
        assert w.stats["grab_conflicts"] == 2
        doc._busy = 0   # commit boundary: the caller owns quiescence now
        data = h.result(30)
    assert data == TC.AsyncCheckpointer.capture(doc)
    assert TC.restore_engine(data, "cpu").text() == doc.text()


def _pipe_doc(n):
    doc = TDoc("p", device="cpu")
    doc.apply_batch(as_port(B.base_batch("p", n)))
    return doc


def test_async_capture_during_pipeline_is_consistent_prefix():
    n = 3000
    doc = _pipe_doc(n)
    halves = [as_port(B.merge_batch("p", 10, 50, n, seed=s, actor_prefix=p_))
              for s, p_ in ((1, "a"), (2, "b"))]
    with TC.AsyncCheckpointer() as w:
        with PipelinedIngestor(doc) as pipe:
            pipe.feed(halves[0])
            h = w.capture_async(doc)
            pipe.feed(halves[1])
            pipe.flush()
        restored = TC.restore_engine(h.result(60), "cpu")
    # the capture is SOME consistent prefix: replaying the halves on top
    # converges it to the final doc (idempotent dedup absorbs the rest)
    restored.apply_batch(halves[0])
    restored.apply_batch(halves[1])
    assert restored.text() == doc.text()


# --------------------------------------------------------------------------
# api.load envelope validation
# --------------------------------------------------------------------------


def test_load_rejects_non_dict_payload_typed():
    for bad in ("[1]", '"str"', "3", "null"):
        with pytest.raises(ProtocolError):
            T.load(bad, where(T))


def test_load_rejects_missing_changes_typed():
    with pytest.raises(ProtocolError):
        T.load('{"format": "automerge-tpu-v1"}', where(T))
    with pytest.raises(ProtocolError):
        T.load('{"format": "automerge-tpu-v1", "changes": 5}', where(T))


def test_load_unknown_format_still_value_error():
    with pytest.raises(ValueError):
        T.load('{"format": "something-else", "changes": []}', where(T))
    assert issubclass(ProtocolError, ValueError)
    assert issubclass(CheckpointError, ProtocolError)


# --------------------------------------------------------------------------
# grab races
# --------------------------------------------------------------------------


def test_grab_mid_mutation_serves_commit_boundary_snapshot():
    """A grab observing a mutation in flight reads the doc's cached
    commit-boundary snapshot with zero coordination."""
    doc, _ = _port_text_doc(200)
    bytes0 = TC.AsyncCheckpointer.capture(doc)   # caches the snapshot
    doc._busy = 1                                # a bulk merge mid-flight
    try:
        with TC.AsyncCheckpointer(max_grab_retries=2) as w:
            data = w.capture_async(doc).result(30)
            assert w.stats["snapshot_serves"] == 1
            assert w.stats["sync_fallbacks"] == 0
            assert w.stats["grab_conflicts"] == 0
    finally:
        doc._busy = 0
    assert data == bytes0                        # the commit-boundary state


def test_grab_racing_bulk_index_merge_is_consistent_prefix():
    """Async grabs racing a thread of real applies (each holding _busy
    across its bulk index merge): every capture restores to SOME
    consistent prefix."""
    n = 2000
    doc = _pipe_doc(n)
    batches = [as_port(B.merge_batch("p", 8, 40, n, seed=s, actor_prefix=p))
               for s, p in ((1, "a"), (2, "b"), (3, "c"), (4, "d"))]
    seed = TC.AsyncCheckpointer.capture(doc)
    with TC.AsyncCheckpointer() as w:
        handles = []
        done = threading.Event()

        def mutate():
            for b in batches:
                doc.apply_batch(b)
            done.set()

        t = threading.Thread(target=mutate)
        t.start()
        while not done.is_set() and len(handles) < 12:
            handles.append(w.capture_async(doc))
            time.sleep(0.01)
        t.join(60)
        captures = [seed] + [h.result(60) for h in handles]
        assert w.stats["grab_conflicts"] == 0, w.stats
    final = doc.text()
    for data in captures:
        restored = TC.restore_engine(data, "cpu")
        for b in batches:
            restored.apply_batch(b)
        assert restored.text() == final


def test_snapshot_not_served_for_donation_enabled_doc():
    """A cached commit-boundary snapshot is NOT served once the doc
    enters in-place mode: the busy path falls back to CaptureConflict."""
    doc, _ = _port_text_doc(200)
    TC.AsyncCheckpointer.capture(doc)            # caches the snapshot
    doc.donate_buffers = True
    try:
        with pytest.raises(CaptureConflict):
            grab(doc)                            # deferred grab refuses
        doc._busy = 1
        with pytest.raises(CaptureConflict):
            grab(doc, inline=True)               # busy + in place: no serve
    finally:
        doc._busy = 0
        doc.donate_buffers = False
    assert grab(doc)["mode"] == "live"


def test_donation_refuses_deferred_checkpoint_grab():
    """Twin of tests/test_pipeline.py: an in-place doc refuses the
    deferred grab, while the inline grab — encoded before any further
    commit — captures, and equals the JAX package's capture."""
    doc = TDoc("t", device="cpu")
    doc.eager_materialize = True
    doc.apply_batch(as_port(B.base_batch("t", 4000)))
    doc.text()
    jdoc = JDoc("t")
    jdoc.apply_batch(B.base_batch("t", 4000))
    doc.donate_buffers = True
    with pytest.raises(CaptureConflict):
        grab(doc)
    g = grab(doc, inline=True)
    assert g["obj_id"] == "t"
    data = TC.AsyncCheckpointer.capture(doc)
    assert data == JC.capture_engine(jdoc)
    with PipelinedIngestor(doc, donate=True) as ring:
        ring.run([as_port(B.merge_batch("t", 20, 20, 4000, seed=4))])
        # a capture request inside the session degrades to the sync path
        with TC.AsyncCheckpointer() as w:
            h = w.capture_async(doc)
            h._done.wait(30)
            assert w.stats["sync_fallbacks"] == 1
        ring.flush()
        assert TC.restore_engine(h.result(30), "cpu").text() == doc.text()


def test_inplace_session_since_grab_kills_cached_snapshot():
    """The torch trap: an in-place round overwrites the storage a cached
    grab references, and the tensor shows it only in its version
    counter. A snapshot taken before such a session is not served after
    it; one taken before an out-of-place round still is."""
    n = 4000
    doc = _pipe_doc(n)
    with PipelinedIngestor(doc, donate=True) as ring:      # tables -> store
        ring.run([as_port(B.merge_batch("p", 40, 30, n, seed=1,
                                        actor_prefix="s1"))])
    assert doc._store is not None and doc._store.holds(doc._dev)
    before = TC.AsyncCheckpointer.capture(doc)
    doc._busy = 1
    assert grab(doc)["mode"] == "snapshot"                 # servable now
    doc._busy = 0
    cap = doc._store.cap
    with PipelinedIngestor(doc, donate=True) as ring:      # writes in place
        ring.run([as_port(B.merge_batch("p", 5, 10, n, seed=2,
                                        actor_prefix="s2"))])
    assert doc._store.cap == cap and doc._store.holds(doc._dev)
    assert doc._last_grab is not None
    doc._busy = 1
    try:
        with pytest.raises(CaptureConflict):
            grab(doc)
    finally:
        doc._busy = 0
    assert doc._last_grab is None                          # dropped
    after = TC.AsyncCheckpointer.capture(doc)
    assert after != before
    assert TC.restore_engine(after, "cpu").text() == doc.text()
    # an out-of-place round leaves a cached snapshot servable
    doc.apply_batch(as_port(B.merge_batch("p", 3, 10, n, seed=3,
                                          actor_prefix="s3")))
    doc._busy = 1
    try:
        served = grab(doc)
    finally:
        doc._busy = 0
    assert served["mode"] == "snapshot"
    assert TC.writer.encode_engine_grab(served) == after


# --------------------------------------------------------------------------
# small-scale restore equivalence (bench.py measure_restore's shape)
# --------------------------------------------------------------------------


def test_restore_metrics_small_scale_equivalence():
    """bench.py measure_restore at toy scale on the port: the full replay
    of the base + tail logs and the snapshot restore + tail replay reach
    the same document, and the port's bundle is the JAX package's."""
    from automerge_tpu_torch.engine.columnar import TextChangeBatch as PB
    obj, base_n, tail_actors, ops = "ckpt-text", 4000, 4, 40
    base_json = B._base_changes_json(obj, base_n)
    tail_json = B._tail_changes_json(obj, tail_actors, ops, base_n)
    doc = TDoc(obj, capacity=base_n + 1, device="cpu")
    doc.apply_batch(PB.from_json(base_json, obj))
    bundle = TC.capture_engine(doc)
    jdoc = JDoc(obj, capacity=base_n + 1)
    jdoc.apply_batch(JB.from_json(base_json, obj))
    assert bundle == JC.capture_engine(jdoc)
    full = TDoc(obj, capacity=base_n + 1, device="cpu")
    full.apply_batch(PB.from_json(base_json, obj))
    full.apply_batch(PB.from_json(tail_json, obj))
    snap = TC.restore_engine(bundle, "cpu")
    snap.apply_batch(PB.from_json(tail_json, obj))
    expect = base_n + tail_actors * (ops // 2)
    for d in (full, snap):
        d._materialize(with_pos=False)
        assert int(d._scalars()[0]) == expect
    assert snap.text() == full.text()
    assert TC.capture_engine(snap) == TC.capture_engine(full)


# --------------------------------------------------------------------------
# failure atomicity next to restore (tests/test_failure_atomicity.py)
# --------------------------------------------------------------------------


def ins(obj, key, elem):
    return {"action": "ins", "obj": obj, "key": key, "elem": elem}


def setop(obj, key, value):
    return {"action": "set", "obj": obj, "key": key, "value": value}


def test_redelivery_after_failed_batch_applies():
    doc = TDoc("obj1", device="cpu")
    bad = {"actor": "a", "seq": 1, "deps": {},
           "ops": [ins("obj1", "ghost:99", 1), setop("obj1", "a:1", "x")]}
    with pytest.raises(ValueError, match="unknown parent"):
        doc.apply_changes([bad])
    assert doc.clock == {}
    assert ("a", 1) not in doc._all_deps
    doc.apply_changes([{"actor": "a", "seq": 1, "deps": {},
                        "ops": [ins("obj1", "_head", 1),
                                setop("obj1", "a:1", "x")]}])
    assert doc.text() == "x" and doc.clock == {"a": 1}


def test_prior_state_survives_failed_batch_and_checkpoints():
    """The failed batch leaves the clock, the text and the checkpoint of
    the prior state (actor interning keeps the failed batch's actors in
    both packages: the bundles stay equal to the JAX package's)."""
    good = {"actor": "a", "seq": 1, "deps": {},
            "ops": [ins("obj1", "_head", 1), setop("obj1", "a:1", "h")]}
    bad = {"actor": "b", "seq": 1, "deps": {},
           "ops": [ins("obj1", "nowhere:7", 1), setop("obj1", "b:1", "y")]}
    doc, jdoc = TDoc("obj1", device="cpu"), JDoc("obj1")
    for d in (doc, jdoc):
        d.apply_changes([good])
        with pytest.raises(ValueError):
            d.apply_changes([bad])
    assert doc.clock == {"a": 1} and doc.text() == "h"
    data = TC.capture_engine(doc)
    assert data == JC.capture_engine(jdoc)
    back = TC.restore_engine(data, "cpu")
    assert back.clock == {"a": 1} and back.text() == "h"
    for d in (doc, back):
        d.apply_changes([{"actor": "b", "seq": 1, "deps": {},
                          "ops": [ins("obj1", "a:1", 1),
                                  setop("obj1", "b:1", "i")]}])
        assert d.text() == "hi"


def test_previously_queued_change_not_dropped():
    doc = TDoc("obj1", device="cpu")
    doc.apply_changes([{"actor": "b", "seq": 2, "deps": {},
                        "ops": [ins("obj1", "b:1", 2),
                                setop("obj1", "b:2", "2")]}])
    assert len(doc.queue) == 1
    with pytest.raises(ValueError, match="unknown parent"):
        doc.apply_changes([{"actor": "b", "seq": 1, "deps": {},
                            "ops": [ins("obj1", "ghost:1", 1),
                                    setop("obj1", "b:1", "x")]}])
    assert doc.clock == {} and len(doc.queue) == 1
    doc.apply_changes([{"actor": "b", "seq": 1, "deps": {},
                        "ops": [ins("obj1", "_head", 1),
                                setop("obj1", "b:1", "1")]}])
    assert doc.text() == "12" and doc.queue == []


def test_backend_failing_batch_leaves_prior_state_usable():
    doc = _doc_with_history()
    state = T.frontend.get_backend_state(doc)
    before = TC.capture_state(state)
    text_id = T.get_object_id(doc["t"])
    bad = {"actor": "mallory", "seq": 1, "deps": dict(state.clock), "ops": [
        {"action": "ins", "obj": text_id, "key": "ghost:9", "elem": 1}]}
    with pytest.raises(Exception):
        CPU.apply_changes(state, [bad])
    assert TC.capture_state(state) == before
    after = T.change(doc, lambda d: d["t"].insert_at(0, "!"))
    assert str(after["t"]) == "!ntegrity"


def test_failed_restore_leaves_no_state(monkeypatch):
    """A corrupt bundle raises before any document is built, any table
    staged or any footprint fed."""
    from automerge_tpu_torch.engine import accounting
    from automerge_tpu_torch.engine import base as engine_base
    from automerge_tpu_torch.obs import device_truth as dt
    doc, _ = _port_text_doc(300)
    engine = bytearray(TC.capture_engine(doc))
    engine[-5] ^= 0x10
    backend = T.checkpoint_doc(_doc_with_history()).data[:-7]
    built = []
    real_init = engine_base.CausalDeviceDoc.__init__

    def counted(self, *a, **k):
        built.append(type(self).__name__)
        real_init(self, *a, **k)
    monkeypatch.setattr(engine_base.CausalDeviceDoc, "__init__", counted)
    gauges = dt.REGISTRY.footprint()["gauges"]
    h2d = accounting.snapshot()["h2d_bytes"]
    with pytest.raises(CheckpointError):
        TC.restore_engine(bytes(engine), "cpu")
    with pytest.raises(CheckpointError):
        TC.restore_state(backend, "cpu")
    with pytest.raises(CheckpointError):
        T.restore(backend, where(T))
    assert built == []
    assert accounting.snapshot()["h2d_bytes"] == h2d
    assert dt.REGISTRY.footprint()["gauges"] == gauges


# --------------------------------------------------------------------------
# on the card: the worker's d2h waits for the producing kernels
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_async_capture_waits_for_producing_stream(card):
    """The grab records an event on the caller's stream and the worker's
    stream waits on it: tables produced by kernels still queued behind a
    long sleep on the caller's stream are read only after they ran."""
    n = 20_000
    doc = TDoc("w", device=card)
    doc.apply_batch(as_port(B.base_batch("w", n)))
    doc.apply_batch(as_port(B.merge_batch("w", 50, 40, n, seed=1)))
    want = TC.AsyncCheckpointer.capture(doc)
    for _ in range(3):
        torch.cuda._sleep(200_000_000)       # the caller's stream is busy
        doc._dev = {k: t.clone() for k, t in doc._dev.items()}
        doc._invalidate()
        with TC.AsyncCheckpointer() as w:
            got = w.capture_async(doc).result(60)
        assert got == want
    assert TC.restore_engine(want, card).text() == doc.text()
