"""Device-truth telemetry: library builds, kernel launches and device
memory of the PyTorch/CUDA engine.

The port of the JAX package's ``obs/device_truth.py``, redesigned for the
card with the same read side (`REGISTRY`, `summary`, `families`,
`counter_events`, `note_footprint` / `drop_footprint` / `footprint` and
the peak, `steady_state`, `attribute_device_time`, `roofline_seconds`).
The JAX module watches XLA compiles and reads XLA's cost analysis; the
port compiles no programs at run time, so its counterparts are:

- **Build and load events ("compiles").** The two compiled libraries —
  the CUDA kernels (`ops/scan_kernels.py`, nvcc) and the host codec
  (`native/`, g++) — report each compile (`build`) and each bind of a
  library into the process (`load`) with its wall time and the library
  file (its name carries the source digest). After warm-up there are
  none: :class:`steady_state` asserts that over a timed region.
- **Per-label launch registry.** Each hand-written kernel's wrapper feeds
  a :class:`KernelHandle` per route — ``cuda`` where it launches the
  kernel, ``plain`` where a CPU tensor takes the plain PyTorch version —
  with the bytes the call must move and the operations it does, computed
  from its shape (the roofline inputs; no cost analysis to read).
- **Footprint.** `CausalDeviceDoc.device_footprint()` sums the distinct
  storages (`untyped_storage().nbytes()`) the live tables sit in — an
  in-place document's tables are rows of one buffer per dtype, so the
  storage, not dtype x shape, is what the device holds — and commits and
  restores feed the per-doc gauge here (`note_footprint`). `peak_bytes`
  is the high-water mark of the summed gauges; on a card the summary adds
  ``torch.cuda.max_memory_allocated``.
- **Read side.** Always-on aggregates (`summary()`, merged into
  ``obs.metrics_snapshot()["device_truth"]``), Prometheus
  ``amtpu_device_*`` families (`families()`), Perfetto counter tracks in
  every exported trace (`counter_events()`), and the attribution helpers
  that split a measured device time over the dispatch labels by the
  bytes their kernels moved.

``AMTPU_DEVICE_TRUTH=0`` turns the per-launch feed off (the wrappers then
skip one flag check); the default is on.

Label coverage contract: every ``label=`` an engine `_count_dispatch`
site carries must be a key of :data:`DISPATCH_LABEL_KERNELS` (its value
names the hand-written kernels that program launches on a card, each
registered here), and every `_count_sync` label a member of
:data:`SYNC_LABELS`.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

#: THE fast-path gate: the kernel wrappers read this module attribute per
#: call. Default ON; AMTPU_DEVICE_TRUTH=0 turns the feed off.
ENABLED = os.environ.get("AMTPU_DEVICE_TRUTH", "1") not in ("", "0")

_LOCK = threading.Lock()

#: accounting dispatch label -> the hand-written kernels the labeled
#: program launches on a card (empty: plain PyTorch operations only)
DISPATCH_LABEL_KERNELS = {
    "fused_commit_round": ("multi_scan", "fused_segment_scans"),
    "fused_commit_planned": ("multi_scan",),
    "fused_mixed_round": ("multi_scan",),
    "fused_stacked_round": ("multi_scan",),
    "materialize": ("fused_segment_scans",),
    "apply_map_round": (),
    "scatter_registers": (),
    "fused_scatter": (),
    "pack_rows": (),
    "rga_linearize": (),
    "remap_actors": (),
    "remap_ranks": (),
    "stacked_gather": (),
    "stacked_linearize": (),
    "stacked_mirror_fetch": (),
    "stacked_unstack": (),
}

#: `_count_sync` labels: blocking d2h fetches and completion barriers
SYNC_LABELS = frozenset({
    "stage_barrier",          # prepare-side h2d completion barrier
    "mirror_fetch",           # packed host-mirror fetch (pack_rows)
    "slow_info_fetch",        # the residual path's one packed round trip
    "scalars_fetch",          # read path's visible-count fetch
    "positions_fetch",        # RGA position pull
    "codes_pull",             # O(doc) codes buffer pull
    "rga_linearize",          # position fetch after linearize
    "stacked_slow_info",      # stacked packed slow residue fetch
    "stacked_mirror_fetch",   # stacked packed mirror re-seed fetch
})

#: the card's peaks for `roofline_seconds` (NVIDIA H100 SXM data sheet:
#: HBM3 rate; the non-tensor fp32 rate, taken for int32 adds)
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = 67e12


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


class KernelHandle:
    """One hand-written kernel's launch counters on one route, registered
    under (label, variant): variant ``cuda`` counts launches of the
    kernel, ``plain`` calls that took the plain PyTorch version (a CPU
    tensor). `note` is the wrapper's one call per launch."""

    __slots__ = ("label", "variant", "calls", "bytes", "ops")

    def __init__(self, label: str, variant: str):
        self.label = label
        self.variant = variant
        self.calls = 0
        self.bytes = 0
        self.ops = 0

    def note(self, n_bytes: int, n_ops: int):
        with _LOCK:
            self.calls += 1
            self.bytes += n_bytes
            self.ops += n_ops

    def __repr__(self):
        return (f"<KernelHandle {self.label}/{self.variant} "
                f"calls={self.calls}>")


class DeviceTruthRegistry:
    """The per-process launch registry, build/load log and footprint
    meter. Every read copies under the one lock; the bounded rings
    (build events, counter-track samples) evict oldest while the
    aggregate counters stay exact."""

    def __init__(self):
        self._kernels: "OrderedDict[tuple, KernelHandle]" = OrderedDict()
        self._events = deque(maxlen=_env_int("AMTPU_DEVICE_TRUTH_EVENTS",
                                             1024))
        # two SEPARATE counter-track sample rings: build samples are rare
        # and precious, footprint samples arrive per commit — sharing one
        # ring would let a busy session evict every build sample
        self._samples = deque(maxlen=_env_int("AMTPU_DEVICE_TRUTH_SAMPLES",
                                              4096))
        self._fp_samples = deque(maxlen=_env_int(
            "AMTPU_DEVICE_TRUTH_SAMPLES", 4096))
        self._libs: dict = {}         # (library, variant) -> [n, ns]
        self.compiles_total = 0       # build + load events
        self.compile_ns_total = 0
        self._footprint: dict = {}    # (kind, key) -> bytes gauge
        self._doc_bytes_total = 0     # running sum of the doc gauges —
        # maintained by delta so the per-commit feed is O(1)
        self.peak_bytes = 0

    # -- registration / launches ---------------------------------------

    def register(self, label: str, variant: str) -> KernelHandle:
        with _LOCK:
            h = self._kernels.get((label, variant))
            if h is None:
                h = self._kernels[(label, variant)] = KernelHandle(
                    label, variant)
            return h

    def kernels(self) -> dict:
        """{(label, variant): {"calls", "bytes", "ops"}}."""
        with _LOCK:
            return {k: {"calls": h.calls, "bytes": h.bytes, "ops": h.ops}
                    for k, h in self._kernels.items()}

    def registered_kernel_names(self) -> set:
        with _LOCK:
            return {label for (label, _v) in self._kernels}

    def touched(self) -> bool:
        """Whether the session built or loaded a library, metered a
        footprint or launched a registered kernel."""
        with _LOCK:
            return bool(self.compiles_total or self.peak_bytes or any(
                h.calls for h in self._kernels.values()))

    # -- build / load events ("compiles") -------------------------------

    def record_build(self, library: str, variant: str, wall_ns: int,
                     sig: str):
        """One compile (``build``) or bind (``load``) of a compiled
        library; `sig` names the library file (source digest)."""
        with _LOCK:
            ent = self._libs.setdefault((library, variant), [0, 0])
            ent[0] += 1
            ent[1] += int(wall_ns)
            self.compiles_total += 1
            self.compile_ns_total += int(wall_ns)
            ts = time.perf_counter_ns()
            self._events.append({
                "ts_ns": ts, "label": library, "variant": variant,
                "wall_ns": int(wall_ns), "sig": sig,
                "n_for_label": ent[0]})
            self._samples.append((ts, {
                "compiles_total": self.compiles_total,
                "compile_seconds_total": self.compile_ns_total / 1e9}))

    def compile_events(self) -> list:
        with _LOCK:
            return [dict(e) for e in self._events]

    def compile_snapshot(self) -> dict:
        """Point-in-time build/load counters for delta taking (the
        steady-state assertion's input)."""
        with _LOCK:
            return {"compiles_total": self.compiles_total,
                    "by_kernel": {k: v[0] for k, v in self._libs.items()}}

    def compiles_since(self, snap: dict) -> dict:
        """{(library, variant): n_new_events} since `snap` (only nonzero
        entries; empty == steady state)."""
        cur = self.compile_snapshot()
        base = snap.get("by_kernel", {})
        return {k: n - base.get(k, 0)
                for k, n in cur["by_kernel"].items()
                if n - base.get(k, 0) > 0}

    def recompile_report(self) -> list:
        """Libraries built or loaded more than once in the session, with
        the library files each event named: [{label, variant,
        n_compiles, distinct_signatures, signatures}]."""
        by_key: dict = {}
        for e in self.compile_events():
            by_key.setdefault((e["label"], e["variant"]), []).append(
                e["sig"])
        with _LOCK:
            totals = {k: v[0] for k, v in self._libs.items()}
        out = []
        for key, n in sorted(totals.items()):
            if n <= 1:
                continue
            sigs = by_key.get(key, [])
            out.append({"label": key[0], "variant": key[1],
                        "n_compiles": n,
                        "distinct_signatures": len(set(sigs)),
                        "signatures": sigs[-8:]})
        return out

    # -- cost model (measured launch bytes) ------------------------------

    def kernel_costs(self) -> dict:
        """Per-kernel cost model merged over routes: {label: {"calls",
        "bytes_per_call", "ops_per_call"}} — the mean bytes and
        operations of the launches this session made."""
        with _LOCK:
            acc: dict = {}
            for (label, _v), h in self._kernels.items():
                a = acc.setdefault(label, [0, 0, 0])
                a[0] += h.calls
                a[1] += h.bytes
                a[2] += h.ops
        return {label: {"calls": n, "bytes_per_call": b / n,
                        "ops_per_call": o / n}
                for label, (n, b, o) in acc.items() if n}

    # -- footprint ------------------------------------------------------

    def note_footprint(self, kind: str, key: str, nbytes: int):
        """Feed one device-resident footprint gauge (kind "doc") and roll
        the peak-total high-water mark. O(1) per call: the doc total is
        maintained by gauge delta, and a counter-track sample lands only
        when the total actually moved."""
        nbytes = int(nbytes)
        with _LOCK:
            old = self._footprint.get((kind, key), 0)
            self._footprint[(kind, key)] = nbytes
            if kind != "doc" or nbytes == old:
                return
            self._doc_bytes_total += nbytes - old
            total = self._doc_bytes_total
            if total > self.peak_bytes:
                self.peak_bytes = total
            self._fp_samples.append((time.perf_counter_ns(), total))

    def drop_footprint(self, kind: str, key: str):
        with _LOCK:
            old = self._footprint.pop((kind, key), None)
            if kind == "doc" and old:
                self._doc_bytes_total -= old

    def footprint(self) -> dict:
        with _LOCK:
            out = {"gauges": {f"{k}:{key}": v
                              for (k, key), v in sorted(
                                  self._footprint.items())},
                   "device_bytes_total": self._doc_bytes_total,
                   "peak_device_bytes": self.peak_bytes}
        cuda = _cuda_peak()
        if cuda is not None:
            out["cuda_max_memory_allocated"] = cuda
        return out

    # -- export surfaces ------------------------------------------------

    def summary(self) -> dict:
        """The always-on aggregate view merged into
        obs.metrics_snapshot()["device_truth"]."""
        with _LOCK:
            kernels = {f"{label}/{v}": {"calls": h.calls, "bytes": h.bytes,
                                        "ops": h.ops}
                       for (label, v), h in sorted(self._kernels.items())
                       if h.calls}
            libs = {f"{lib}/{v}": {"events": n,
                                   "wall_ms": round(ns / 1e6, 3)}
                    for (lib, v), (n, ns) in sorted(self._libs.items())}
            out = {
                "compiles_total": self.compiles_total,
                "compile_seconds_total": round(
                    self.compile_ns_total / 1e9, 4),
                "libraries": libs,
                "kernels": kernels,
            }
        out["recompiles"] = self.recompile_report()
        out["footprint"] = self.footprint()
        from ..engine import accounting
        tot = accounting.snapshot()
        out["staged_bytes"] = {"h2d": tot.get("h2d_bytes", 0),
                               "d2h": tot.get("d2h_bytes", 0)}
        return out

    def families(self, prefix: str = "amtpu_device") -> list:
        """Prometheus exposition families (validate_prom-clean by
        construction)."""
        with _LOCK:
            kernel_rows = [((label, v), h.calls, h.bytes)
                           for (label, v), h in sorted(
                               self._kernels.items())]
            libs = sorted(self._libs.items())
            fp = dict(self._footprint)
            peak = self.peak_bytes
            compiles_total = self.compiles_total
        from ..engine import accounting
        tot = accounting.snapshot()
        fams = [
            (f"{prefix}_kernel_calls_total", "counter",
             "Hand-written kernel calls per route (cuda: launches; "
             "plain: the plain PyTorch version on a CPU tensor).",
             [({"kernel": k, "variant": v}, calls)
              for (k, v), calls, _b in kernel_rows if calls]),
            (f"{prefix}_kernel_bytes_total", "counter",
             "Bytes the kernel calls must move (inputs read once, "
             "outputs written once).",
             [({"kernel": k, "variant": v}, b)
              for (k, v), calls, b in kernel_rows if calls]),
            (f"{prefix}_compiles_total", "counter",
             "Builds and loads of the compiled libraries (the port's "
             "compile events).",
             [({"kernel": lib, "variant": v}, n)
              for (lib, v), (n, _ns) in libs]
             + [({"kernel": "_all", "variant": "_all"}, compiles_total)]),
            (f"{prefix}_compile_seconds_total", "counter",
             "Wall seconds spent building and loading each library.",
             [({"kernel": lib, "variant": v}, ns / 1e9)
              for (lib, v), (_n, ns) in libs if ns]),
            (f"{prefix}_staged_bytes_total", "counter",
             "Exact staged transfer bytes at the counted engine seams.",
             [({"direction": "h2d"}, tot.get("h2d_bytes", 0)),
              ({"direction": "d2h"}, tot.get("d2h_bytes", 0))]),
            (f"{prefix}_peak_footprint_bytes", "gauge",
             "High-water mark of summed per-doc device table bytes.",
             [({}, peak)]),
        ]
        if fp:
            fams.append((
                f"{prefix}_footprint_bytes", "gauge",
                "Device-resident bytes per doc (the storages its tables "
                "sit in, plus cached device buffers).",
                [({"kind": k, "key": key}, v)
                 for (k, key), v in sorted(fp.items())]))
        cuda = _cuda_peak()
        if cuda is not None:
            fams.append((
                f"{prefix}_cuda_max_memory_allocated_bytes", "gauge",
                "torch.cuda.max_memory_allocated of the current card.",
                [({}, cuda)]))
        return fams

    def counter_events(self, t0_ns: int, pid: int = 1) -> list:
        """Chrome trace counter-track ("C"-phase) samples: build/load
        totals (their own ring) and device-resident bytes over session
        time, stitched into every exported trace (obs/export.py)."""
        with _LOCK:
            samples = list(self._samples)
            fp_samples = list(self._fp_samples)
        out = []
        for ts, vals in samples:
            if ts < t0_ns:
                continue
            for name, v in vals.items():
                out.append({"ph": "C", "name": f"amtpu_device_{name}",
                            "cat": "device_truth", "pid": pid, "tid": 0,
                            "ts": (ts - t0_ns) / 1000.0,
                            "args": {"value": round(v, 3)}})
        for ts, total in fp_samples:
            if ts < t0_ns:
                continue
            out.append({"ph": "C",
                        "name": "amtpu_device_device_bytes_total",
                        "cat": "device_truth", "pid": pid, "tid": 0,
                        "ts": (ts - t0_ns) / 1000.0,
                        "args": {"value": total}})
        return out

    def clear_session(self):
        """Reset per-session events and gauges (the kernel handles
        persist: the wrappers hold them)."""
        with _LOCK:
            self._events.clear()
            self._samples.clear()
            self._fp_samples.clear()
            self._footprint.clear()
            self._doc_bytes_total = 0
            self.peak_bytes = 0


def _cuda_peak() -> Optional[int]:
    """torch.cuda.max_memory_allocated when the process touched a card
    (never initializes CUDA itself)."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return int(torch.cuda.max_memory_allocated())
    return None


REGISTRY = DeviceTruthRegistry()


def register(label: str, variant: str) -> KernelHandle:
    return REGISTRY.register(label, variant)


def record_build(library: str, variant: str, wall_ns: int, sig: str):
    REGISTRY.record_build(library, variant, wall_ns, sig)


def summary() -> dict:
    return REGISTRY.summary()


def families(prefix: str = "amtpu_device") -> list:
    return REGISTRY.families(prefix)


class steady_state:
    """Context manager asserting no library was built or loaded inside
    the region:

        with device_truth.steady_state() as ss:
            ... the timed reps ...
        ss.assert_zero()        # or read ss.recompiles
    """

    def __init__(self):
        self.recompiles: dict = {}

    def __enter__(self):
        self._snap = REGISTRY.compile_snapshot()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.recompiles = REGISTRY.compiles_since(self._snap)
        return False

    def assert_zero(self):
        if self.recompiles:
            events = [e for e in REGISTRY.compile_events()
                      if (e["label"], e["variant"]) in self.recompiles]
            named = [(e["label"], e["variant"], e["sig"])
                     for e in events[-8:]]
            raise AssertionError(
                f"builds/loads at steady state: {self.recompiles} — "
                f"events: {named}")


# ---------------------------------------------------------------------------
# cost-model attribution
# ---------------------------------------------------------------------------


def _label_cost(label: str, costs: dict) -> tuple:
    """(ops_per_call, bytes_per_call) of one ACCOUNTING label: the sum
    over the kernels its program launches (DISPATCH_LABEL_KERNELS; an
    unmapped label falls back to its own name)."""
    names = DISPATCH_LABEL_KERNELS.get(label, (label,))
    ops = sum(costs.get(n, {}).get("ops_per_call", 0.0) for n in names)
    bys = sum(costs.get(n, {}).get("bytes_per_call", 0.0) for n in names)
    return ops, bys


def attribute_device_time(label_calls: dict, total_s: float) -> dict:
    """Split a measured device-time total into per-label shares by the
    bytes their kernels moved (calls x bytes per call — these kernels
    are bound by bytes): {label: share_s}, summing to `total_s`. Labels
    whose programs launch no registered kernel weigh in at the median
    bytes/call, so they are visible, never silently dropped."""
    costs = REGISTRY.kernel_costs()
    known = [c["bytes_per_call"] for c in costs.values()
             if c["bytes_per_call"] > 0]
    fallback = sorted(known)[len(known) // 2] if known else 1.0
    weights = {}
    for label, n in label_calls.items():
        if n <= 0:
            continue
        _, per_call = _label_cost(label, costs)
        weights[label] = n * (per_call if per_call > 0 else fallback)
    wsum = sum(weights.values())
    if wsum <= 0:
        return {}
    return {label: round(total_s * w / wsum, 6)
            for label, w in sorted(weights.items())}


def roofline_seconds(label_calls: dict,
                     peak_flops: Optional[float] = None,
                     peak_bw: Optional[float] = None) -> dict:
    """The least time the given per-label call counts could take: sum
    over labels of calls x max(ops/peak_flops, bytes/peak_bw), from the
    registered kernels' measured bytes and operations per call. Peaks
    come from AMTPU_PEAK_FLOPS / AMTPU_PEAK_BYTES_PER_S or the H100's
    data sheet on a card (rough host numbers on the CPU, a sanity band
    only)."""
    import torch
    platform = "cuda" if torch.cuda.is_available() else "cpu"
    if peak_flops is None:
        peak_flops = float(os.environ.get(
            "AMTPU_PEAK_FLOPS",
            H100_OPS_PER_S if platform == "cuda" else 5e10))
    if peak_bw is None:
        peak_bw = float(os.environ.get(
            "AMTPU_PEAK_BYTES_PER_S",
            H100_BYTES_PER_S if platform == "cuda" else 3e10))
    costs = REGISTRY.kernel_costs()
    total = 0.0
    per_label = {}
    for label, n in label_calls.items():
        ops, bys = _label_cost(label, costs)
        if n <= 0 or (ops == 0.0 and bys == 0.0):
            continue
        t = n * max(ops / peak_flops, bys / peak_bw)
        per_label[label] = round(t, 6)
        total += t
    return {"seconds": round(total, 6), "per_label": per_label,
            "peak_flops": peak_flops, "peak_bytes_per_s": peak_bw,
            "platform": platform}
