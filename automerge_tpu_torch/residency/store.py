"""The warm/cold bundle store behind the residency manager.

A demoted doc's entire state is its AMTPUCKPT1 checkpoint bundle
(versioned manifest + per-array SHA-256 — `checkpoint/engine_codec.py`):
the spill format IS the checkpoint format, so a spilled doc restores by
pure h2d table staging (`ShardLane.adopt` -> `restore_engine`), never by
replay, and every page-in re-verifies the integrity hashes for free.

Two tiers live here:

- **warm**: bundle bytes in host memory (`dict`), the fast page-in tier;
- **cold**: bundle bytes aged to one file per doc under ``spill_dir``
  (atomic ``os.replace`` writes; file names are sha1(doc_id) so a doc id
  is never a path traversal). With no ``spill_dir`` configured the cold
  tier is disabled and warm bundles simply stay warm.

The store never decides WHEN to demote/age — that is the manager's
policy — it only guarantees nothing is ever lost between tiers: a doc is
in exactly one of {warm, cold} or absent, and the accounting surface
(`tiers()`, byte gauges) is exact.
"""

from __future__ import annotations

import hashlib
import os

from ..engine import learned_index


class BundleStore:
    """Host-side (warm) + disk (cold) checkpoint-bundle store."""

    def __init__(self, spill_dir: str = None):
        self.spill_dir = spill_dir
        self._warm: dict = {}           # doc_id -> bundle bytes
        self._cold: dict = {}           # doc_id -> (path, nbytes)
        self._gen = 0                   # membership generation: bumps on
        self._learned = None            # put/pop; (gen, ids, model pair)
        self.stats = {"puts": 0, "gets": 0, "ages": 0, "loads": 0,
                      "peak_warm_bytes": 0, "peak_cold_bytes": 0}

    # -- tier membership -----------------------------------------------

    def __contains__(self, doc_id: str) -> bool:
        return doc_id in self._warm or doc_id in self._cold

    def member_mask(self, doc_ids):
        """Batched stored-membership of ``doc_ids`` — ONE learned/packed
        position probe over the store's sorted id table instead of a
        per-doc ``in`` probe each, with the full-key equality gate of
        `learned_index.actor_positions` guaranteeing exactness (a model
        miss or a packed-prefix collision still answers exactly). The
        table + model are cached per membership generation (put/pop
        bumps — the same token discipline as the interning-generation
        retrain trigger). Returns a bool array aligned to ``doc_ids``,
        or None when the "residency_clock" site is demoted, the ids cannot
        pack (non-ASCII) or the packed table is not strictly increasing —
        the caller then takes the exact per-doc probes."""
        if not learned_index.site_enabled("residency_clock"):
            return None
        ent = self._learned
        if ent is None or ent[0] != self._gen:
            ids = sorted([*self._warm, *self._cold])
            tk = learned_index.pack_str_keys(ids)
            pair = None
            if tk is not None and (len(tk) < 2
                                   or bool((tk[1:] > tk[:-1]).all())):
                pair = (tk, learned_index.fit_model(tk, "residency_clock"))
            ent = (self._gen, ids, pair)
            self._learned = ent
        _gen, ids, pair = ent
        if pair is None:
            return None
        got = learned_index.actor_positions(ids, doc_ids,
                                            "residency_clock", pair)
        if got is None:
            return None
        return got[1]

    def tier(self, doc_id: str):
        if doc_id in self._warm:
            return "warm"
        if doc_id in self._cold:
            return "cold"
        return None

    def warm_ids(self) -> list:
        return sorted(self._warm)

    def cold_ids(self) -> list:
        return sorted(self._cold)

    @property
    def warm_bytes(self) -> int:
        return sum(len(b) for b in self._warm.values())

    @property
    def cold_bytes(self) -> int:
        return sum(n for _, n in self._cold.values())

    # -- write side ----------------------------------------------------

    def put(self, doc_id: str, bundle: bytes):
        """Admit a freshly demoted doc to the warm tier (a re-demote
        overwrites: the newest bundle is the doc's only truth)."""
        self._cold.pop(doc_id, None)
        self._warm[doc_id] = bundle
        self._gen += 1
        self.stats["puts"] += 1
        wb = self.warm_bytes
        if wb > self.stats["peak_warm_bytes"]:
            self.stats["peak_warm_bytes"] = wb

    def _cold_path(self, doc_id: str) -> str:
        digest = hashlib.sha1(doc_id.encode()).hexdigest()
        return os.path.join(self.spill_dir, f"{digest}.amtpuckpt")

    def age(self, doc_id: str) -> bool:
        """Warm -> cold: write the bundle to its spill file (atomic
        tmp + replace) and drop the host copy. No-op (False) without a
        spill_dir or when the doc is not warm."""
        if self.spill_dir is None or doc_id not in self._warm:
            return False
        os.makedirs(self.spill_dir, exist_ok=True)
        path = self._cold_path(doc_id)
        bundle = self._warm[doc_id]
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(bundle)
        os.replace(tmp, path)
        del self._warm[doc_id]
        self._cold[doc_id] = (path, len(bundle))
        self.stats["ages"] += 1
        cb = self.cold_bytes
        if cb > self.stats["peak_cold_bytes"]:
            self.stats["peak_cold_bytes"] = cb
        return True

    # -- read side -----------------------------------------------------

    def peek(self, doc_id: str):
        """The doc's bundle bytes without changing its tier (the
        capture/read path: a demoted doc's checkpoint IS its stored
        bundle, byte-identical to a live capture). None when absent."""
        bundle = self._warm.get(doc_id)
        if bundle is not None:
            return bundle
        entry = self._cold.get(doc_id)
        if entry is None:
            return None
        path, _nbytes = entry
        with open(path, "rb") as fh:
            return fh.read()

    def pop(self, doc_id: str):
        """Remove and return the bundle (the page-in path). A cold hit
        counts a disk load and deletes the spill file — the doc is
        becoming device-resident again; the bundle in hand is the only
        copy by design (one tier at a time)."""
        bundle = self._warm.pop(doc_id, None)
        if bundle is not None:
            self._gen += 1
            self.stats["gets"] += 1
            return bundle
        entry = self._cold.pop(doc_id, None)
        if entry is None:
            return None
        self._gen += 1
        path, _nbytes = entry
        with open(path, "rb") as fh:
            bundle = fh.read()
        try:
            os.remove(path)
        except OSError:
            pass
        self.stats["gets"] += 1
        self.stats["loads"] += 1
        return bundle

    def tiers(self) -> dict:
        """The full accounting surface: every stored doc named in its
        tier, with exact byte totals."""
        return {"warm": self.warm_ids(), "cold": self.cold_ids(),
                "warm_bytes": self.warm_bytes,
                "cold_bytes": self.cold_bytes}
