"""Device-resident map/counter CRDT document (PyTorch).

The PyTorch counterpart of `automerge_tpu/engine/map_doc.py`, the map
analogue of `DeviceTextDoc`: key registers live as padded columnar tables
(torch tensors on the document's `device`) and whole batches of changes
merge per causally-ready round in one round program
(`ops/ingest.py:apply_map_round`). This replaces the reference's per-op
map reconciliation (`applyAssign` on map objects, reference
backend/op_set.js:196-258) with scatter-based LWW resolution over interned
key slots:

- keys intern to dense int32 slots (host dictionary; slot = register index)
- the device fast path resolves empty-register sets and same-actor
  overwrites; concurrent multi-writer rounds, deletes, counter increments
  and pooled (non-inline-int) values flow through the shared host slow
  path (engine/base.py) with the oracle's semantics: winner = highest
  actor id, concurrent survivors are conflicts, `inc` folds into
  causally-visible counter values. Each round fetches one packed
  `slow_info` matrix for it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..ops.ingest import REG_FILLS, REG_KEYS
from .base import CausalDeviceDoc
from .columnar import MapChangeBatch


class DeviceMapDoc(CausalDeviceDoc):
    """One map object: interned keys -> LWW registers on the device."""

    batch_type = MapChangeBatch
    _TABLE_KEYS = REG_KEYS
    _TABLE_FILLS = REG_FILLS

    def __init__(self, obj_id: str = "map", capacity: int = 256,
                 device=None):
        from ..ops.ingest import bucket
        super().__init__(obj_id, device)
        self.key_table: list = []             # slot -> key string
        self._key_slot: dict = {}
        self._cap = bucket(max(capacity, 16))

    # ------------------------------------------------------------------
    # device state
    # ------------------------------------------------------------------

    def reserve(self, n: int):
        """Raise the capacity floor so upcoming applies jump straight to
        bucket(n) instead of growing through every intermediate bucket.
        Safe with live tables: the round extends them to out_cap."""
        from ..ops.ingest import bucket
        self._cap = max(self._cap, bucket(max(n, 16)))

    def _ensure_dev(self) -> dict:
        self._check_device_alive()
        if self._dev is None:
            cap, dev = self._cap, self.device
            i32 = dict(dtype=torch.int32, device=dev)
            b = dict(dtype=torch.bool, device=dev)
            self._dev = {
                "value": torch.zeros(cap, **i32),
                "has_value": torch.zeros(cap, **b),
                "win_actor": torch.full((cap,), -1, **i32),
                "win_seq": torch.zeros(cap, **i32),
                "win_counter": torch.zeros(cap, **b),
            }
        return self._dev

    def _mirrors(self) -> dict:
        if self._host is None:
            self._host = self._fetch_mirrors(
                ("value", "has_value", "win_counter"))
        return self._host

    def _remap_device(self, remap: np.ndarray):
        from ..ops.ingest import remap_ranks
        dev = self._ensure_dev()
        self._count_dispatch(label="remap_ranks")
        dev["win_actor"] = remap_ranks(dev["win_actor"], self._to_dev(remap))

    def _intern_keys(self, keys) -> np.ndarray:
        for k in keys:
            if k not in self._key_slot:
                self._key_slot[k] = len(self.key_table)
                self.key_table.append(k)
        return np.asarray([self._key_slot[k] for k in keys], np.int32)

    # ------------------------------------------------------------------
    # round ingestion
    # ------------------------------------------------------------------

    def _plan_map_round(self, b: MapChangeBatch, mask):
        """HOST planning of one causally-ready round of map ops: key
        interning + resolved op columns, zero device work. None for an
        empty round. `val64` keeps the unclipped values the host slow path
        needs (pool refs survive clipping; int64 magnitudes do not)."""
        from ..ops.ingest import bucket

        kind = np.ascontiguousarray(b.op_kind[mask])
        n_ops = len(kind)
        if n_ops == 0:
            return None
        op_key = b.op_key[mask]
        val64 = b.op_value[mask]
        op_row = b.op_change[mask]

        key_map = self._intern_keys(b.key_table)   # batch kid -> global slot
        slot = key_map[op_key]
        row_actor_rank = np.asarray(
            [self._actor_rank[a] for a in b.actors], np.int32)
        row_seq = np.asarray(b.seqs, np.int32)
        return {
            "n_ops": n_ops, "kind": kind, "slot": slot,
            "value": np.clip(val64, -2**31, 2**31 - 1).astype(np.int32),
            "win_actor": row_actor_rank[op_row],
            "win_seq": row_seq[op_row], "val64": val64,
            "out_cap": max(bucket(len(self.key_table)), self._cap),
        }

    def _ingest(self, b: MapChangeBatch, mask):
        from ..ops.ingest import apply_map_round, bucket

        p = self._plan_map_round(b, mask)
        if p is None:
            return
        n_ops = p["n_ops"]
        kind = p["kind"]
        out_cap = p["out_cap"]
        dev = self._ensure_dev()
        M = bucket(n_ops, 128)

        def padm(arr, fill, dtype=np.int32):
            out = np.full(M, fill, dtype)
            out[:n_ops] = arr
            return self._to_dev(out)

        K = bucket(max(len(self.conflicts), 1), 64)
        conflict_slots = np.full(K, out_cap, np.int32)
        if self.conflicts:
            conflict_slots[: len(self.conflicts)] = list(self.conflicts)

        self._count_dispatch(label="apply_map_round")
        # exact h2d meter: the round's op columns (one int8 + four int32
        # M-padded arrays) + the conflict-slot vector
        self._count_h2d(M * (1 + 4 * 4) + K * 4)
        (value_n, has_n, wa_n, ws_n, wc_n, slow_info) = apply_map_round(
            dev["value"], dev["has_value"], dev["win_actor"],
            dev["win_seq"], dev["win_counter"],
            padm(kind, -1, np.int8), padm(p["slot"], out_cap),
            padm(p["value"], 0),
            padm(p["win_actor"], 0), padm(p["win_seq"], 0),
            self._to_dev(conflict_slots), out_cap=out_cap)

        self._dev = {"value": value_n, "has_value": has_n, "win_actor": wa_n,
                     "win_seq": ws_n, "win_counter": wc_n}
        self._cap = out_cap
        self._host = None

        # one packed transfer: slow mask + slots + register state (the
        # FULL padded buffer crosses the link; the n_ops slice is a view)
        _ts = obs.now() if obs.ENABLED else 0
        info_full = slow_info.cpu().numpy()
        self._count_sync(label="slow_info_fetch",
                         dur_ns=(obs.now() - _ts) if _ts else 0,
                         d2h_bytes=info_full.nbytes)
        info = info_full[:, :n_ops]
        if info[0].any():
            idxs = np.nonzero(info[0])[0]
            self._apply_slow(
                b, info[1][idxs], kind[idxs], p["val64"][idxs],
                p["win_actor"][idxs], p["win_seq"][idxs],
                slot_cap=self._cap,
                reg_state=tuple(info[r][idxs] for r in range(2, 7)))

    # ------------------------------------------------------------------
    # accessors
    # ------------------------------------------------------------------

    def _decode(self, v: int):
        if v >= 0:
            return int(v)
        return self.value_pool[-v - 1]["value"]

    def to_dict(self) -> dict:
        h = self._mirrors()
        out = {}
        for key, slot in self._key_slot.items():
            if h["has_value"][slot]:
                out[key] = self._decode(int(h["value"][slot]))
        return out

    def get(self, key: str, default=None):
        slot = self._key_slot.get(key)
        if slot is None:
            return default
        h = self._mirrors()
        if not h["has_value"][slot]:
            return default
        return self._decode(int(h["value"][slot]))

    def conflicts_for(self, key: str):
        slot = self._key_slot.get(key)
        extras = self.conflicts.get(slot) if slot is not None else None
        if not extras:
            return None
        return {self.actor_table[op["actor_rank"]]: self._decode(op["value"])
                for op in extras}

    def __len__(self) -> int:
        h = self._mirrors()
        n = len(self.key_table)
        return int(h["has_value"][:n].sum())

    def __contains__(self, key: str) -> bool:
        slot = self._key_slot.get(key)
        if slot is None:
            return False
        return bool(self._mirrors()["has_value"][slot])
