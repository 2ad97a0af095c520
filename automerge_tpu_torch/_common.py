"""Shared primitives: root id, elemId parsing, vector-clock comparison.

Counterpart of the reference's ``src/common.js`` (see
reference src/common.js:1-48), re-expressed for Python. Clocks are plain
``dict[str, int]`` throughout the framework — the wire format is JSON, and
device kernels operate on interned/densified clock matrices instead (device
engine, built in ``automerge_tpu.ops``).
"""

from __future__ import annotations


# The root object of every document (src/common.js:1).
ROOT_ID = "00000000-0000-0000-0000-000000000000"

# Columnar op kinds shared by the engine's batch encoding and the device
# ingest kernels (ops/ingest.py). Values are part of the columnar format.
KIND_INS, KIND_SET, KIND_DEL, KIND_INC = 0, 1, 2, 3
HEAD_PARENT = -1  # parent-actor encoding for the virtual list head ('_head')

# The device tier's numeric envelope. Every device column is int32 (the
# TPU emulates int64; docs/MEASUREMENTS.md), elemId keys pack as
# (actor_rank << 32 | ctr) into int64 (engine/host_index.py), and actor
# ranks reproduce the reference's string ordering (op_set.js:432-436) as
# int32 comparisons — so counters, seqs, and ranks past 2^31-1 would
# silently wrap into WRONG ORDERING, not crash. check_int32_envelope is
# the one loud gate every packing/encoding site calls.
INT32_MAX = 2**31 - 1


def check_int32_envelope(name: str, arr, lo: int = 0):
    """Raise OverflowError when any value of `arr` (numpy array or int)
    falls outside [lo, INT32_MAX]. O(n) vectorized; the guarded sites are
    already O(n) column passes."""
    import numpy as _np
    arr = _np.asarray(arr)
    if arr.size == 0:
        return
    mx, mn = arr.max(), arr.min()
    if mx > INT32_MAX or mn < lo:
        bad = int(mx if mx > INT32_MAX else mn)
        raise OverflowError(
            f"{name} value {bad} outside the device int32 envelope "
            f"[{lo}, {INT32_MAX}]: the columnar tier packs elemId "
            "counters, seqs, and actor ranks as int32/int64-keys and a "
            "wrap would silently reorder elements (op_set.js:432-436 "
            "ordering); shard or re-key the document instead")

# elemId = "<actorId>:<counter>" — counter is a Lamport timestamp unique per list.


def is_object(value) -> bool:
    return isinstance(value, (dict, list))


def less_or_equal(clock1: dict, clock2: dict) -> bool:
    """True iff every component of clock1 is <= the one in clock2.

    Mirrors src/common.js:27-31: false means clock1 is greater or the clocks
    are incomparable (concurrent states).
    """
    for key in set(clock1) | set(clock2):
        if clock1.get(key, 0) > clock2.get(key, 0):
            return False
    return True


def parse_elem_id(elem_id: str):
    """Split an ``actorId:counter`` element ID into (actor_id, counter).

    Mirrors src/common.js:38-44. rsplit instead of the regex (the regex
    matched `(.*):(\\d+)` with a greedy prefix — identical split point);
    this sits on the per-op interactive hot path."""
    if elem_id:
        actor, sep, ctr = elem_id.rpartition(":")
        if sep and ctr.isdigit():
            return actor, int(ctr)
    raise ValueError(f"Not a valid elemId: {elem_id}")


def make_elem_id(actor_id: str, counter: int) -> str:
    return f"{actor_id}:{counter}"


def transitive_deps(states: dict, base_deps: dict) -> dict:
    """Full vector clock implied by `base_deps` over an actor-states map
    ``{actor: [{"change": ..., "allDeps": ...}, ...]}`` (the reference's
    transitiveDeps, reference backend/op_set.js:29-37). Shared by the
    oracle index and the device backend so the closure semantics cannot
    drift."""
    deps: dict = {}
    for dep_actor, dep_seq in base_deps.items():
        if dep_seq <= 0:
            continue
        lst = states.get(dep_actor, [])
        if dep_seq <= len(lst):  # unknown deps contribute no closure
            for a, s in lst[dep_seq - 1]["allDeps"].items():
                if s > deps.get(a, 0):
                    deps[a] = s
        deps[dep_actor] = dep_seq
    return deps
