#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (automerge_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--profile DIR]

It builds the CUDA kernels from csrc/ and holds each kernel bit-exact
against its plain PyTorch version: at the main path's shapes, at ragged
and tile-edge sizes, on unaligned views, twice in a row on one shape (a
reused scratch) and 50 times at each merge shape. It then drives the
port's DeviceTextDoc through the headline text merge at full width (a
1,000,000-char document taking a 10,000-actor x 1,000-op concurrent
batch), the self-contained materialization, and a residual round with the
incremental pull; times each kernel at every shape those paths launched
it with (device time over CUDA-graph replays, inputs rotated through
copies so each call reads them from HBM; one eager call at the merge
shapes is timed before the paths); and checks that each wrapper call runs
one kernel. Every phase raises on failure.
With --profile, it then runs the headline commit (commit_prepared +
_materialize + _scalars) of each materialization path once more under
torch.profiler, prints the device's busy share and the kernels that took
the most device time, and writes the Chrome traces to DIR.

The output ends with three lines: one JSON object describing every
kernel, the card's name and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

BASE_LEN = 1_000_000
N_ACTORS = 10_000
OPS_PER_CHANGE = 1_000
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12          # non-tensor fp32 rate, taken for int32 adds
REPS = 25
REPEATS = 50                   # bit-exact launches at each merge shape
MAX_COPIES = 64                # input copies a kernel timing rotates through
N_MERGE = 6_291_456            # bucket(5,000,000 run elements, 256)


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --- the headline stream (copies of bench.py base_batch / merge_batch) ---

def base_batch(TB, C, obj_id: str, n: int):
    """One bulk change typing an n-char document (a single run)."""
    ta = np.zeros(2 * n, np.int32)
    tc = np.zeros(2 * n, np.int32)
    pa = np.full(2 * n, C.HEAD_PARENT, np.int32)
    pc = np.zeros(2 * n, np.int32)
    val = np.zeros(2 * n, np.int64)
    kind = np.tile(np.array([C.KIND_INS, C.KIND_SET], np.int8), n)
    ctrs = np.arange(1, n + 1, dtype=np.int32)
    tc[0::2] = ctrs
    tc[1::2] = ctrs
    pa[2::2] = 0
    pc[2::2] = ctrs[:-1]
    val[1::2] = 97 + (ctrs % 26)
    return TB(
        obj_id=obj_id, actors=["base"], seqs=np.array([1], np.int32),
        deps=[{}], messages=[None],
        op_change=np.zeros(2 * n, np.int32), op_kind=kind,
        op_target_actor=ta, op_target_ctr=tc,
        op_parent_actor=pa, op_parent_ctr=pc, op_value=val,
        actor_table=["base"], value_pool=[])


def merge_targets(n_actors: int, base_n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.zipf(1.2, n_actors).clip(1, base_n)  # hot-region targets


def merge_batch(TB, C, obj_id: str, n_actors: int, ops_per_change: int,
                base_n: int, seed: int = 0, actor_prefix: str = "actor"):
    """n_actors concurrent changes, each a typing run of ops_per_change ops
    starting at a Zipfian-hot position in the base document."""
    run = ops_per_change // 2            # ins+set pairs
    n_ops = n_actors * run * 2
    actors = [f"{actor_prefix}-{i:06d}" for i in range(n_actors)]
    op_change = np.repeat(np.arange(n_actors, dtype=np.int32), run * 2)
    kind = np.tile(np.array([C.KIND_INS, C.KIND_SET], np.int8),
                   n_actors * run)
    ta = np.repeat(np.arange(n_actors, dtype=np.int32), run * 2)
    tc = np.zeros(n_ops, np.int32)
    pa = np.zeros(n_ops, np.int32)
    pc = np.zeros(n_ops, np.int32)
    val = np.zeros(n_ops, np.int64)
    ctrs = np.arange(1, run + 1, dtype=np.int32) + base_n + 1
    targets = merge_targets(n_actors, base_n, seed)
    for a in range(n_actors):
        s = a * run * 2
        tc[s: s + 2 * run: 2] = ctrs
        tc[s + 1: s + 2 * run: 2] = ctrs
        pa[s] = n_actors                  # 'base' in the actor table
        pc[s] = int(targets[a])
        pa[s + 2: s + 2 * run: 2] = a
        pc[s + 2: s + 2 * run: 2] = ctrs[:-1]
        val[s + 1: s + 2 * run: 2] = 97 + (a % 26)
    return TB(
        obj_id=obj_id, actors=actors, seqs=np.ones(n_actors, np.int32),
        deps=[{"base": 1}] * n_actors, messages=[None] * n_actors,
        op_change=op_change, op_kind=kind, op_target_actor=ta,
        op_target_ctr=tc, op_parent_actor=pa, op_parent_ctr=pc,
        op_value=val, actor_table=actors + ["base"], value_pool=[])


def expected_merge_text(base_n: int, n_actors: int, run: int) -> str:
    """Independent reference of the merged text: every run hangs off its
    base target and all runs share one head counter, so RGA orders the runs
    after one target by descending actor id; a run's characters are one
    letter repeated."""
    by_target: dict = {}
    for a, t in enumerate(merge_targets(n_actors, base_n).tolist()):
        by_target.setdefault(t, []).append(a)
    parts = []
    for i in range(1, base_n + 1):
        parts.append(chr(97 + i % 26))
        for a in reversed(by_target.get(i, ())):
            parts.append(chr(97 + a % 26) * run)
    return "".join(parts)


def sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


# --- timing -----------------------------------------------------------------

def n_copies(torch, in_bytes: int) -> int:
    """Input copies for a timing to rotate through, so that each call reads
    its input from HBM and not from the L2 (where a loop over one input
    would keep it): between two reads of one copy, the other copies' bytes
    fill the L2 at least twice. At most MAX_COPIES, so an input under
    2 * L2 / (MAX_COPIES - 1) (1.7 MB on an H100) may stay in the L2."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 * 2**20)
    return min(MAX_COPIES, 1 + -(-2 * l2 // max(in_bytes, 1)))


def time_ms(torch, fns, reps: int = REPS, calls: int = 10) -> float:
    """Device time of one call: CUDA events around the replay of a CUDA
    graph of at least `calls` calls cycling through `fns` (one per input
    copy), so no host work sits between the launches; the median of `reps`
    replays, over the calls."""
    calls = len(fns) * -(-calls // len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns[:2]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def time_eager_ms(torch, fn, reps: int = REPS) -> float:
    """Median of `reps` CUDA-event timings of one eager fn() call after two
    warm-ups: the device time plus whatever host work the call does while
    the device waits."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- phases -----------------------------------------------------------------

def _fs_inputs(torch, rng, C, dev, lead: int = 0):
    """Seeded chain / has_value columns of length C (views `lead` bytes
    into a longer tensor when lead > 0)."""
    chain = torch.from_numpy(rng.random(C + lead) < 0.9).to(dev)[lead:]
    has = torch.from_numpy(rng.random(C + lead) < 0.95).to(dev)[lead:]
    return chain, has


def _fs_equal(torch, got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def kernels_per_call(torch, fn) -> int:
    """Device kernels one call of fn() runs, its memsets aside."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memset" not in e.name.lower())


def check_kernels(torch, S):
    """Kernels vs plain versions on the card, bit-exact: ragged and
    tile-edge sizes, unaligned views, a reused scratch, and 50 repeats at
    each merge shape."""
    rng = np.random.default_rng(1234)
    dev = torch.device("cuda")
    lib = S.load()
    ms_tile = lib.amt_multi_scan_tile()
    fs_tile = lib.amt_fused_scan_tile()
    log(f"tiles: multi_scan {ms_tile} columns, fused_segment_scans "
        f"{fs_tile} slots")
    shapes = [(6, 1), (6, 256), (6, 1000), (6, 1025), (6, 1_048_576),
              (6, N_MERGE)]
    for K in (1, 6, 13):
        for N in (4095, 4096, 4097, 2 * ms_tile + 3):
            shapes.append((K, N))
    for K, N in shapes:
        x = torch.from_numpy(
            rng.integers(-50, 50, (K, N), dtype=np.int32)).to(dev)
        want = S.multi_scan_plain(x)
        for call in range(2):                  # the second reuses scratch
            got = S.multi_scan(x)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"multi_scan differs at ({K}, {N}), call {call}")
    log(f"multi_scan bit-exact vs plain, two calls each: {shapes}")
    # a (6, 8192) view 4 bytes off 16-byte alignment: the scalar path
    buf = torch.from_numpy(
        rng.integers(-50, 50, 6 * 8192 + 1, dtype=np.int32)).to(dev)
    x = buf[1:].view(6, 8192)
    if x.data_ptr() % 16 == 0 or not torch.equal(S.multi_scan(x),
                                                 S.multi_scan_plain(x)):
        raise AssertionError("multi_scan differs on an unaligned view")
    log("multi_scan bit-exact on a view 4 bytes off alignment")

    cases = [(1, 1, 0, 0), (1025, 900, 0, 0), (1025, 2000, 7, 0),
             (fs_tile - 1, fs_tile - 5, 0, 0), (fs_tile + 1, fs_tile, 3, 0),
             (2 * fs_tile + 3, 2 * fs_tile, 0, 0),
             (100_003, 90_000, 4096, 1), (fs_tile * 3, fs_tile * 2, 0, 1),
             (1_048_576, BASE_LEN, 0, 0), (N_MERGE, 6_000_000, 0, 0), (N_MERGE, 5_999_000, 4096, 0),
             (N_MERGE, 6_000_000, 0, 1)]
    for C, n_elems, base, lead in cases:
        chain, has = _fs_inputs(torch, rng, C, dev, lead)
        if lead and chain.data_ptr() % 16 == 0:
            raise AssertionError("the unaligned case is aligned")
        want = S.fused_segment_scans_plain(chain, has, n_elems, base)
        for call in range(2):
            got = S.fused_segment_scans(chain, has, n_elems, base)
            torch.cuda.synchronize()
            if not _fs_equal(torch, got, want):
                raise AssertionError(
                    f"fused_segment_scans differs at C={C} n_elems={n_elems}"
                    f" base={base} offset={lead} call {call}")
        log(f"fused_segment_scans C={C} n_elems={n_elems} base={base} "
            f"byte offset {lead}: bit-exact vs plain, two calls")

    # 50 launches at each merge shape, every one bit-exact
    x = torch.from_numpy(
        rng.integers(-50, 50, (6, N_MERGE), dtype=np.int32)).to(dev)
    want = S.multi_scan_plain(x)
    chain, has = _fs_inputs(torch, rng, N_MERGE, dev)
    ne = torch.tensor(6_000_000, dtype=torch.int32, device=dev)
    want_fs = S.fused_segment_scans_plain(chain, has, ne)
    for i in range(REPEATS):
        if not torch.equal(S.multi_scan(x), want):
            raise AssertionError(f"multi_scan repeat {i} differs")
        if not _fs_equal(torch, S.fused_segment_scans(chain, has, ne),
                         want_fs):
            raise AssertionError(f"fused_segment_scans repeat {i} differs")
    log(f"{REPEATS} repeats at each merge shape: all bit-exact")


def check_kernels_per_call(torch, S):
    """Each wrapper call runs one device kernel (its memset aside). Runs
    after the driven paths: a profiler session left behind slows the
    host's later launches."""
    dev = torch.device("cuda")
    x = torch.zeros((6, N_MERGE), dtype=torch.int32, device=dev)
    c = torch.zeros(N_MERGE, dtype=torch.bool, device=dev)
    ne = torch.tensor(6_000_000, dtype=torch.int32, device=dev)
    per_call = {
        "multi_scan": kernels_per_call(torch, lambda: S.multi_scan(x)),
        "fused_segment_scans": kernels_per_call(
            torch, lambda: S.fused_segment_scans(c, c, ne))}
    log(f"device kernels per wrapper call (memsets aside): {per_call}")
    if per_call != {"multi_scan": 1, "fused_segment_scans": 1}:
        raise AssertionError(f"expected one kernel per call: {per_call}")
    return per_call


def _ms_bound(K, N):
    # reads and writes 4 bytes per element; one add per element
    return bound(2 * K * N * 4, K * N)


def _fs_bound(C):
    # reads chain + has (1 B each) and n_elems, writes three int32 columns
    return bound(2 * C + 4 + 3 * 4 * C, 3 * C)


def ms_copies(torch, rng, K, N, dev):
    """Seeded int32 (K, N) inputs for a timing, one per copy."""
    return [torch.from_numpy(rng.integers(-50, 50, (K, N), dtype=np.int32))
            .to(dev) for _ in range(n_copies(torch, 4 * K * N))]


def fs_copies(torch, rng, C, dev):
    """Seeded (chain, has_value) pairs for a timing, one per copy."""
    return [_fs_inputs(torch, rng, C, dev)
            for _ in range(n_copies(torch, 2 * C))]


def ms_calls(torch, S, x):
    """multi_scan on x: (kernel, plain version, library call)."""
    return (lambda: S.multi_scan(x), lambda: S.multi_scan_plain(x),
            lambda: torch.cumsum(x, 1, dtype=torch.int32))


def fs_calls(torch, S, chain, has, ne):
    """fused_segment_scans on (chain, has, ne): (kernel, plain version,
    library yardstick: the three library scans alone on precomputed
    inputs)."""
    flat = torch.arange(chain.shape[0], dtype=torch.int32,
                        device=chain.device)
    is_elem = (flat >= 1) & (flat <= ne)
    ss = (is_elem & ~chain).to(torch.int32)
    cand = torch.where(ss > 0, flat, 0)
    vis = (is_elem & has).to(torch.int32)

    def library():
        torch.cumsum(ss, 0, dtype=torch.int32)
        torch.cummax(cand, 0)
        torch.cumsum(vis, 0, dtype=torch.int32)
    return (lambda: S.fused_segment_scans(chain, has, ne),
            lambda: S.fused_segment_scans_plain(chain, has, ne), library)


def time_eager_merge(torch, S):
    """One eager call of each kernel, its plain version and the library
    call at the merge shapes, on one input; returns each kernel's time.
    This runs before the driven paths on purpose: the first timed commit
    of a process moves with what ran before it, and earlier versions of
    this script ran these same calls there, so their commit times compare
    with this one's."""
    rng = np.random.default_rng(42)
    dev = torch.device("cuda")
    x = torch.from_numpy(
        rng.integers(-50, 50, (6, N_MERGE), dtype=np.int32)).to(dev)
    chain, has = _fs_inputs(torch, rng, N_MERGE, dev)
    ne = torch.tensor(6_000_000, dtype=torch.int32, device=dev)
    out = {}
    for name, calls in (("multi_scan", ms_calls(torch, S, x)),
                        ("fused_segment_scans",
                         fs_calls(torch, S, chain, has, ne))):
        kern, plain, lib = (time_eager_ms(torch, f) for f in calls)
        out[name] = kern
        log(f"{name} at the merge shape, one eager call: kernel "
            f"{kern:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms")
    return out


def time_kernels(torch, S, ms_shapes, fs_shapes, n_elems_of):
    """Kernel, plain and library device times at every shape each kernel
    launched with on the driven paths; returns {name: [per-shape record]}.
    The kernel is timed over input copies (n_copies); the plain and
    library versions, hundreds of times slower, over the first copy."""
    rng = np.random.default_rng(99)
    dev = torch.device("cuda")
    out = {"multi_scan": [], "fused_segment_scans": []}
    for K, N in sorted(ms_shapes, key=lambda s: s[0] * s[1]):
        xs = ms_copies(torch, rng, K, N, dev)
        kern = [ms_calls(torch, S, x)[0] for x in xs]
        _, plain, library = ms_calls(torch, S, xs[0])
        err = int((S.multi_scan(xs[0]) - S.multi_scan_plain(xs[0]))
                  .abs().max())
        b_ms, b_by = _ms_bound(K, N)
        out["multi_scan"].append({
            "shape": [K, N], "copies": len(xs), "max_abs_err": err,
            "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, [plain]),
            "library_ms": time_ms(torch, [library]),
            "bound_ms": b_ms, "bound_by": b_by})
        del xs, kern
    for (C,) in sorted(fs_shapes):
        pairs = fs_copies(torch, rng, C, dev)
        ne = torch.tensor(n_elems_of(C), dtype=torch.int32, device=dev)
        kern = [lambda c=c, h=h: S.fused_segment_scans(c, h, ne)
                for c, h in pairs]
        _, plain, library = fs_calls(torch, S, *pairs[0], ne)
        got = S.fused_segment_scans(*pairs[0], ne)
        want = S.fused_segment_scans_plain(*pairs[0], ne)
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        b_ms, b_by = _fs_bound(C)
        out["fused_segment_scans"].append({
            "shape": [C], "copies": len(pairs), "max_abs_err": err,
            "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, [plain]),
            "library_ms": time_ms(torch, [library]),
            "bound_ms": b_ms, "bound_by": b_by})
        del pairs, kern
    for name, recs in out.items():
        for r in recs:
            if r["max_abs_err"] != 0:
                raise AssertionError(f"{name} {r['shape']} differs from "
                                     f"plain by {r['max_abs_err']}")
            r["bound_frac"] = r["bound_ms"] / r["ms"]
            log(f"{name} {r['shape']}: kernel {r['ms']:.4f} ms "
                f"({100 * r['bound_frac']:.1f}% of bound, {r['copies']} "
                f"input copies), plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    return out


def heal_watch(logging_mod):
    """Collect the engine's warnings: a segment-mirror heal must not
    happen on the main path."""
    class Grab(logging_mod.Handler):
        def __init__(self):
            super().__init__(logging_mod.WARNING)
            self.records = []

        def emit(self, record):
            self.records.append(record.getMessage())
    h = Grab()
    logging_mod.getLogger("automerge_tpu_torch.engine").addHandler(h)
    return h


def prepare_stream(DeviceTextDoc, TB, C, device, planned: bool):
    """The headline stream up to the prepared merge: a fresh document
    holding the base text, and the merge batch planned and staged."""
    doc = DeviceTextDoc("bench-text", device=device)
    doc.eager_materialize = True
    doc.prefer_planned = planned
    doc.apply_batch(base_batch(TB, C, "bench-text", BASE_LEN))
    base_text = doc.text()
    merge = merge_batch(TB, C, "bench-text", N_ACTORS, OPS_PER_CHANGE,
                        BASE_LEN)
    t0 = time.perf_counter()
    prepared = doc.prepare_batch(merge)
    return doc, prepared, base_text, time.perf_counter() - t0


def commit_stream(doc, prepared):
    """Commit the prepared merge and materialize; `_scalars` is the one
    device sync."""
    doc.commit_prepared(prepared)
    doc._materialize(with_pos=False)
    return doc._scalars()


def drive_stream(DeviceTextDoc, TB, C, device, planned: bool):
    """The headline stream through the user-facing entry points."""
    doc, prepared, base_text, prepare_s = prepare_stream(
        DeviceTextDoc, TB, C, device, planned)
    t0 = time.perf_counter()
    scal = commit_stream(doc, prepared)
    commit_s = time.perf_counter() - t0
    n_vis = int(scal[0])
    t0 = time.perf_counter()
    text = doc.text()
    pull_s = time.perf_counter() - t0
    return doc, dict(base_text=base_text, text=text, n_vis=n_vis,
                     prepare_s=prepare_s, commit_s=commit_s, pull_s=pull_s,
                     pull=dict(doc.pull_stats or {}))


def profile_commit(torch, DeviceTextDoc, TB, C, planned: bool, out_dir: str,
                   top: int = 14):
    """One headline commit under torch.profiler (the earlier phases have
    warmed the allocator and the kernels): its wall time, the summed
    device time of its kernels, and the kernels that took the most."""
    from torch.profiler import ProfilerActivity, profile
    label = "planned" if planned else "self-contained"
    doc, prepared, _, _ = prepare_stream(DeviceTextDoc, TB, C, None, planned)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scal = commit_stream(doc, prepared)
        wall = time.perf_counter() - t0
    if int(scal[0]) != BASE_LEN + N_ACTORS * (OPS_PER_CHANGE // 2):
        raise AssertionError(f"profiled {label} commit: wrong n_vis")
    # device-side events only (kernels, memcpy, memset): the CPU-side
    # operator rows carry their kernels' time too and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us <= 0:
        raise AssertionError("the profiler saw no device time")
    log(f"profile {label} commit+materialize+sync: wall "
        f"{wall * 1e3:.3f} ms, device kernel time {dev_us / 1e3:.3f} ms, "
        f"device busy share {dev_us / 1e3 / (wall * 1e3):.3f}")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    log("self device ms | calls | kernel")
    for e in events[:top]:
        log(f"{e.self_device_time_total / 1e3:14.4f} | {e.count:5d} | "
            f"{e.key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"torch_commit_{label}.json")
    prof.export_chrome_trace(path)
    log(f"trace: {path}")


def residual_changes(base_n: int):
    """Deletes, overwrites, two conflicting overwrites of one element and
    two concurrent inserts after one element — the round shapes that take
    the mixed round and the host slow path. Net: +2 visible, -5 deleted."""
    ctr = 2 * base_n
    ins = [{"actor": f"zins-{k}", "seq": 1, "deps": {"base": 1}, "ops": [
        {"action": "ins", "obj": "bench-text", "key": "base:500",
         "elem": ctr},
        {"action": "set", "obj": "bench-text",
         "key": f"zins-{k}:{ctr}", "value": "XY"[k]}]} for k in range(2)]
    dels = [{"actor": "zdel", "seq": 1, "deps": {"base": 1}, "ops": [
        {"action": "del", "obj": "bench-text", "key": f"base:{t}"}
        for t in (10, 11, 12, base_n // 13, base_n - 1)]}]
    sets = [{"actor": f"zset-{k}", "seq": 1, "deps": {"base": 1}, "ops": [
        {"action": "set", "obj": "bench-text", "key": f"base:{base_n // 3}",
         "value": "PQ"[k]},
        {"action": "set", "obj": "bench-text", "key": f"base:{300 + k}",
         "value": "R"}]} for k in range(2)]
    return ins + dels + sets


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile the headline commit of both "
                         "materialization paths; traces go to DIR")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from automerge_tpu_torch import _common as C
        from automerge_tpu_torch.engine import accounting
        from automerge_tpu_torch.engine.columnar import TextChangeBatch as TB
        from automerge_tpu_torch.engine.text_doc import DeviceTextDoc
        from automerge_tpu_torch.ops import scan_kernels as S
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules or any(m.startswith("automerge_tpu.")
                                   or m == "automerge_tpu"
                                   for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")

    # 1. device
    card = nvidia_smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"card: {card}")

    # 2. build
    t0 = time.perf_counter()
    built = S.build()
    log(f"build: {built:.2f} s compiling {S.SOURCE.name} "
        f"({time.perf_counter() - t0:.2f} s with the check)")
    for ln in S.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            log(f"ptxas: {ln.strip()}")

    # 3. kernels vs plain, and one eager call of each at the merge shapes
    # (the device-time readings, by CUDA graphs, come after the paths)
    check_kernels(torch, S)
    eager = time_eager_merge(torch, S)
    n_expect = BASE_LEN + N_ACTORS * (OPS_PER_CHANGE // 2)

    # 4. main path at full width
    heals = heal_watch(logging)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    S.reset_launches()
    t_main = time.perf_counter()
    doc, r = drive_stream(DeviceTextDoc, TB, C, None, planned=True)
    main_launches = dict(S.launches)
    main_shapes = {k: dict(v) for k, v in S.launch_shapes.items()}
    t_main = time.perf_counter() - t_main
    peak = torch.cuda.max_memory_allocated()
    log(f"main path launches: {main_launches}")
    if main_launches["multi_scan"] < 1:
        raise AssertionError("multi_scan did not launch on the main path")
    if r["n_vis"] != n_expect or len(r["text"]) != n_expect:
        raise AssertionError(f"n_vis {r['n_vis']} / len {len(r['text'])} "
                             f"!= {n_expect}")
    if any("diverged" in m for m in heals.records):
        raise AssertionError(f"segment mirror healed: {heals.records}")
    want = expected_merge_text(BASE_LEN, N_ACTORS, OPS_PER_CHANGE // 2)
    if r["text"] != want:
        raise AssertionError("merged text differs from the reference")
    n_ops = N_ACTORS * OPS_PER_CHANGE
    log(f"main path ({card}): prepare_s {r['prepare_s']:.4f}, "
        f"commit+sync_s {r['commit_s']:.4f}, "
        f"ops/s {n_ops / r['commit_s']:.0f}, "
        f"text pull_s {r['pull_s']:.4f} ({r['pull']}), "
        f"peak device memory {peak / 2**20:.1f} MiB, "
        f"wall {t_main:.2f} s; text sha256 {sha(r['text'])[:16]}")

    t0 = time.perf_counter()
    cpu_doc, rc = drive_stream(DeviceTextDoc, TB, C, "cpu",
                               planned=True)
    log(f"cpu reference run (plain versions): {time.perf_counter() - t0:.2f}"
        f" s, text sha256 {sha(rc['text'])[:16]}")
    if sha(rc["text"]) != sha(r["text"]):
        raise AssertionError("card text differs from the CPU run")

    # 5. self-contained materialization on a fresh doc
    S.reset_launches()
    doc2, r2 = drive_stream(DeviceTextDoc, TB, C, None,
                            planned=False)
    sc_launches = dict(S.launches)
    sc_shapes = {k: dict(v) for k, v in S.launch_shapes.items()}
    log(f"self-contained path launches: {sc_launches}")
    if sc_launches["fused_segment_scans"] < 1:
        raise AssertionError("fused_segment_scans did not launch in the "
                             "self-contained path")
    if r2["text"] != r["text"]:
        raise AssertionError("self-contained text differs")
    log(f"self-contained ({card}): commit+sync_s {r2['commit_s']:.4f}")
    del doc2

    # 6. residual rounds + incremental pull
    before = dict(accounting.LABELS["dispatch"].get("fused_mixed_round",
                                                    {"n": 0}))
    S.reset_launches()
    doc.apply_changes(residual_changes(BASE_LEN))
    res_launches = dict(S.launches)
    res_shapes = {k: dict(v) for k, v in S.launch_shapes.items()}
    cpu_doc.apply_changes(residual_changes(BASE_LEN))
    mixed = (accounting.LABELS["dispatch"]["fused_mixed_round"]["n"]
             - before["n"])
    inc = doc.text()
    inc_stats = dict(doc.pull_stats)
    doc._text_cache = None
    full = doc.text()
    cpu_text = cpu_doc.text()
    log(f"residual round: fused_mixed_round dispatches {mixed}, launches "
        f"{res_launches}, pull {inc_stats}, conflicts "
        f"{len(doc.conflicts)}")
    if mixed < 1 or res_launches["multi_scan"] < 1:
        raise AssertionError("the residual round missed the mixed round")
    if inc_stats.get("mode") != "incremental":
        raise AssertionError(f"pull was not incremental: {inc_stats}")
    if not (inc == full == cpu_text):
        raise AssertionError("incremental pull differs from a full pull")
    if len(inc) != n_expect + 2 - 5 or not doc.conflicts:
        raise AssertionError("residual round result is wrong")
    if any("diverged" in m for m in heals.records):
        raise AssertionError(f"segment mirror healed: {heals.records}")

    # 7. kernel times at every shape the driven paths launched with, then
    # one kernel per call (a profiler session slows later host launches)
    shapes_by_path = {"main": main_shapes, "self_contained": sc_shapes,
                      "residual": res_shapes}
    log(f"launches by shape on the driven paths: {shapes_by_path}")
    shapes = {k: set().union(*(p[k] for p in shapes_by_path.values()))
              for k in S.launches}
    n_elems_of = {1_048_576: BASE_LEN, N_MERGE: n_expect}
    times = time_kernels(torch, S, shapes["multi_scan"],
                         shapes["fused_segment_scans"],
                         lambda c: n_elems_of.get(c, c - c // 16))
    per_call = check_kernels_per_call(torch, S)

    # 8. optional profile of the headline commit
    if args.profile:
        for planned in (True, False):
            profile_commit(torch, DeviceTextDoc, TB, C, planned,
                           args.profile)

    # 9. kernel records: `launches` is the count on the path the kernel
    # serves (multi_scan: the planned main path; fused_segment_scans: the
    # self-contained one); `launches_by_path` has each driven path's count
    by_path = {"main": main_launches, "self_contained": sc_launches,
               "residual": res_launches}
    kernels = []
    for name, replaces, path in (
            ("multi_scan", "automerge_tpu/ops/scan_pallas.py:204", "main"),
            ("fused_segment_scans", "automerge_tpu/ops/scan_pallas.py:142",
             "self_contained")):
        rec = times[name][-1]                  # the largest (merge) shape
        kernels.append({
            "name": name, "route": "cuda",
            "source": "automerge_tpu_torch/csrc/scan.cu",
            "replaces": replaces, "launches": by_path[path][name],
            "path": path,
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "shape": rec["shape"], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "bound_frac": rec["bound_frac"],
            "eager_ms": eager[name],
            "eager_bound_frac": rec["bound_ms"] / eager[name],
            "kernels_per_call": per_call[name],
            "shapes": times[name],
            "launches_by_shape": {
                p: {"x".join(map(str, sh)): n for sh, n in d[name].items()}
                for p, d in shapes_by_path.items()}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
