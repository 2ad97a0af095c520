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
batch), the self-contained materialization, a residual round with the
incremental pull, bench.py's `--pipeline` stream, a 1,000,000-key map
document, the multi-document tier (phase 8: the stacked executor at
bench.py measure_fused's and a cfg12 lane's populations, the DocSet at
cfg3 with its mirror heal and graduation, each against a CPU run of the
same stream), and the public API (phase 9: cfg4's trellis merge of 1,000
actors through apply_changes, cfg7's interactive latency of 60 local
inserts into a 100,000-char Text, one graduation; each against the
oracle or the CPU backend), and the checkpoint tier (phase 12: bench.py
measure_restore's cold start of a 1,000,000-element text, full replay
against snapshot restore, under obs.tracing(); the API's checkpoint forms
on api-b's document against the CPU backend's bytes; the cfg5f ring with
a capture after each commit, every bundle a consistent prefix); times
each kernel at every shape those paths launched
it with (device time over CUDA-graph replays, inputs rotated through
copies so each call reads them from HBM; one eager call at the merge
shapes is timed before the paths); and checks that each wrapper call runs
one kernel. Every phase raises on failure.
With --profile, it then runs the headline commit (commit_prepared +
_materialize + _scalars) of each materialization path and one stacked
apply and one api-a merge once more under torch.profiler, prints the
device's busy share and the kernels that took the most device time,
writes the Chrome traces to DIR, and prints the host profile (cProfile)
of one stacked apply, one DocSet build and one api-a merge.

The output ends with three lines: one JSON object describing every
kernel, the card's name and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
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
RING_BATCHES = 6               # bench.py --pipeline's stream: 6 batches of
RING_ACTORS = 2_000            # 2,000 actors x 1,000 ops on the base text
RING_DEPTH = 4
RING_REPS = 5                  # timed streams, after one warm-up stream
RING_DISPATCH_BUDGET = 3       # per committed batch (bench.py:528-529)
RING_SYNC_BUDGET = 1
MAP_ACTORS = 1_000             # map phase: 1,000 actors x 1,000 own keys
MAP_KEYS_PER_ACTOR = 1_000
FUSED_TEXT_DOCS = 192          # 8a: bench.py measure_fused's defaults
FUSED_MAP_DOCS = 96
FUSED_KEYS = 64
FUSED_ROUNDS = 6
FUSED_OPS = 8
STACK_REPS = 5                 # timed reps, after one warm-up rep
SHARD_MAP_DOCS = 640           # 8b: bench.py measure_sharded's lane
SHARD_TEXT_DOCS = 64
SHARD_CAP = 2048
SHARD_ROUNDS = 2
DOCSET_DOCS = 1_000            # 8c: benchmarks/run_all.py config3_docset
DOCSET_ACTORS = 10
DOCSET_CHARS = 50
DOCSET_REPS = 5                # fresh timed runs, after one warm-up run
API_ACTORS = 1_000             # api-a: benchmarks/run_all.py config4_trellis
API_CARDS = 10
API_REPS = 5                   # timed merges, after one warm-up merge
API_TEXT = 100_000             # api-b: run_all.py config7_interactive_latency
API_CHANGES = 60
API_SKIP = 10                  # first changes left out of the percentiles
CKPT_TAIL_ACTORS = 64          # ckpt-a: bench.py measure_restore's tail of
CKPT_TAIL_OPS = 200            # 64 actors x 200 ops on the 1,000,000 base


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
              (6, N_MERGE),
              # the stacked rounds' and the DocSet's short rows
              (FUSED_TEXT_DOCS * 6, 256), (SHARD_TEXT_DOCS * 6, 256),
              (DOCSET_DOCS * 5, 512), (7 * 6, 257)]
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

    # the row form: every row scanned on its own with its own count (an
    # all-padding row, a full row, rows of a length off 16 bytes, rows of
    # several tiles)
    for D, C in ((DOCSET_DOCS, 768), (7, 1001), (64, 2 * fs_tile + 3),
                 (3, 16)):
        chain = torch.from_numpy(rng.random((D, C)) < 0.9).to(dev)
        has = torch.from_numpy(rng.random((D, C)) < 0.95).to(dev)
        n = rng.integers(0, C + 1, D).astype(np.int32)
        n[0], n[-1] = 0, C
        ne = torch.from_numpy(n).to(dev)
        want = S.fused_segment_scans_plain(chain, has, ne)
        for call in range(2):
            got = S.fused_segment_scans(chain, has, ne)
            torch.cuda.synchronize()
            if not _fs_equal(torch, got, want):
                raise AssertionError(f"fused_segment_scans rows differ at "
                                     f"({D}, {C}), call {call}")
        log(f"fused_segment_scans rows ({D}, {C}), per-row n_elems: "
            "bit-exact vs plain, two calls")

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


def _fs_bound(shape):
    # reads chain + has (1 B each) and one n_elems per row, writes three
    # int32 columns
    D, C = shape if len(shape) == 2 else (1, shape[0])
    return bound(2 * D * C + 4 * D + 3 * 4 * D * C, 3 * D * C)


def ms_copies(torch, rng, K, N, dev):
    """Seeded int32 (K, N) inputs for a timing, one per copy."""
    return [torch.from_numpy(rng.integers(-50, 50, (K, N), dtype=np.int32))
            .to(dev) for _ in range(n_copies(torch, 4 * K * N))]


def fs_copies(torch, rng, shape, dev):
    """Seeded (chain, has_value) pairs of `shape` ((C,) or rows (D, C))
    for a timing, one per copy."""
    n = int(np.prod(shape))
    return [tuple(t.view(shape) for t in _fs_inputs(torch, rng, n, dev))
            for _ in range(n_copies(torch, 2 * n))]


def ms_calls(torch, S, x):
    """multi_scan on x: (kernel, plain version, library call)."""
    return (lambda: S.multi_scan(x), lambda: S.multi_scan_plain(x),
            lambda: torch.cumsum(x, 1, dtype=torch.int32))


def fs_calls(torch, S, chain, has, ne):
    """fused_segment_scans on (chain, has, ne): (kernel, plain version,
    library yardstick: the three library scans alone on precomputed
    inputs)."""
    flat = torch.arange(chain.shape[-1], dtype=torch.int32,
                        device=chain.device)
    is_elem = (flat >= 1) & (flat <= (ne[:, None] if chain.dim() == 2
                                      else ne))
    ss = (is_elem & ~chain).to(torch.int32)
    cand = torch.where(ss > 0, flat, 0)
    vis = (is_elem & has).to(torch.int32)

    def library():
        torch.cumsum(ss, -1, dtype=torch.int32)
        torch.cummax(cand, -1)
        torch.cumsum(vis, -1, dtype=torch.int32)
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
    for shape in sorted(fs_shapes, key=lambda s: int(np.prod(s))):
        pairs = fs_copies(torch, rng, shape, dev)
        ne = torch.tensor(n_elems_of(shape), dtype=torch.int32, device=dev)
        kern = [lambda c=c, h=h: S.fused_segment_scans(c, h, ne)
                for c, h in pairs]
        _, plain, library = fs_calls(torch, S, *pairs[0], ne)
        got = S.fused_segment_scans(*pairs[0], ne)
        want = S.fused_segment_scans_plain(*pairs[0], ne)
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        b_ms, b_by = _fs_bound(shape)
        out["fused_segment_scans"].append({
            "shape": list(shape), "copies": len(pairs), "max_abs_err": err,
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


# --- the streaming ring (bench.py --pipeline) --------------------------------

def ring_batches(M, base_n: int, n_batches: int, n_actors: int, ops: int):
    """bench.py --pipeline's stream: causally independent merge batches
    whose actor prefixes ascend past 'base' (append-only interning, so
    every prepare after the first chains onto the one before)."""
    return [merge_batch(M.TB, M.C, "pipe-text", n_actors, ops, base_n,
                        seed=100 + k, actor_prefix=f"s{k:03d}")
            for k in range(n_batches)]


def expected_stream_text(base_n: int, n_actors: int, run: int,
                         n_batches: int) -> str:
    """Independent reference of the streamed text (expected_merge_text over
    several batches): every run of every batch hangs off its base target
    with one shared head counter, so the runs after one target order by
    descending actor id s{k:03d}-{a:06d}: by batch, then by actor."""
    by_target: dict = {}
    for k in range(n_batches):
        targets = merge_targets(n_actors, base_n, 100 + k).tolist()
        for a, t in enumerate(targets):
            by_target.setdefault(t, []).append((k, a))
    parts = []
    for i in range(1, base_n + 1):
        parts.append(chr(97 + i % 26))
        for _, a in sorted(by_target.get(i, ()), reverse=True):
            parts.append(chr(97 + a % 26) * run)
    return "".join(parts)


def ring_doc(M, base_n: int, device):
    doc = M.DeviceTextDoc("pipe-text", device=device)
    doc.eager_materialize = True
    doc.apply_batch(base_batch(M.TB, M.C, "pipe-text", base_n))
    doc.text()
    return doc


def fresh(batches):
    """New batch objects over the same columns: no run plan or rank cache
    left by an earlier stream, so every prepare plans and walks anew, as
    for batches that just arrived."""
    return [dataclasses.replace(b) for b in batches]


def reset_counts(M):
    M.S.reset_launches()
    M.native.reset_counts()
    M.runs.detections["calls"] = 0


def ring_stream(torch, M, batches, base_n: int, device, donate: bool,
                depth: int = RING_DEPTH):
    """One stream through PipelinedIngestor, timed as bench.py times it:
    from the first feed to the final _materialize(with_pos=False) and
    _scalars(). The counts are set to 0 just before the ring and read just
    after. Returns (doc, record)."""
    doc = ring_doc(M, base_n, device)
    batches = fresh(batches)
    cuda = doc.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts(M)
    t0 = time.perf_counter()
    with M.PipelinedIngestor(doc, slots=depth, donate=donate) as ring:
        ring.run(batches)
        stats = ring.stats
    doc._materialize(with_pos=False)
    scal = doc._scalars()
    dt = time.perf_counter() - t0
    return doc, {
        "s": dt, "stats": stats, "n_vis": int(scal[0]),
        "launches": dict(M.S.launches),
        "shapes": {k: dict(v) for k, v in M.S.launch_shapes.items()},
        "detections": M.runs.detections["calls"],
        "walks": M.native.walks["native"],
        "peak": torch.cuda.max_memory_allocated() if cuda else 0}


def check_ring(rec: dict, n_batches: int, n_vis: int, cuda: bool):
    """The ring's checks (bench.py --pipeline's, plus the kernel and the
    walker on every commit and prepare); raises on the first failure."""
    st = rec["stats"]
    budget = st["per_commit_budget"]
    if rec["n_vis"] != n_vis:
        raise AssertionError(f"ring n_vis {rec['n_vis']} != {n_vis}")
    if st["committed"] != n_batches:
        raise AssertionError(f"ring committed {st['committed']} batches")
    if (st["chained_prepares"] < n_batches - 1 or st["fallbacks"]
            or st["serial_prepares"]):
        raise AssertionError(f"ring degraded: {st}")
    if (budget["dispatches_max"] > RING_DISPATCH_BUDGET
            or budget["syncs_max"] > RING_SYNC_BUDGET):
        raise AssertionError(f"ring commit over budget: {budget}")
    if cuda and rec["launches"]["multi_scan"] < st["committed"]:
        raise AssertionError("multi_scan missed a ring commit: "
                             f"{rec['launches']} for {st['committed']}")
    if rec["detections"] != st["committed"] or rec["walks"] < st["committed"]:
        raise AssertionError(
            f"the native walker missed a prepare: {rec['detections']} "
            f"detections, {rec['walks']} native walks for "
            f"{st['committed']} prepares")


def serial_stream(torch, M, batches, base_n: int, device):
    """The same stream as a serial schedule: prepare_batch +
    commit_prepared + a device sync per batch. Its terms are read from the
    engine's spans, as bench.py's serial profile reads them."""
    obs = M.obs
    doc = ring_doc(M, base_n, device)
    batches = fresh(batches)
    sync = (torch.cuda.synchronize if doc.device.type == "cuda"
            else (lambda: None))
    with obs.tracing():
        t_rec = obs.now()
        for b in batches:
            doc.commit_prepared(doc.prepare_batch(b))
            with obs.span_ctx("device", "wait"):
                sync()
        with obs.span_ctx("device", "final_sync"):
            doc._materialize(with_pos=False)
            scal = doc._scalars()
        recs = obs.snapshot(since_ns=t_rec)
    terms = {"prepare_s": obs.span_seconds(recs, "plan", "prepare_batch"),
             "commit_s": obs.span_seconds(recs, "commit", "batch"),
             "device_wait_s": obs.span_seconds(recs, "device", "wait"),
             "final_sync_s": obs.span_seconds(recs, "device", "final_sync")}
    return doc, {"terms": terms, "n_vis": int(scal[0])}


def time_walkers(M, batch, base_elems: int, reps: int = 5) -> dict:
    """The native walker, the numpy walker and the sharded detection the
    planner calls, on one merge batch's op columns by direct calls: median
    seconds of `reps` each. The plans must be equal."""
    cols = (batch.op_kind, batch.op_target_actor, batch.op_target_ctr,
            batch.op_parent_actor, batch.op_parent_ctr, batch.op_value,
            batch.op_change)
    out, plans = {}, {}
    for name, fn in (("native_s", M.runs._detect_runs_single),
                     ("numpy_s", M.runs._detect_runs_numpy),
                     ("sharded_s", M.runs.detect_runs)):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            plans[name] = fn(*cols, base_elems)
            times.append(time.perf_counter() - t0)
        out[name] = float(np.median(times))
    for f in ("hpos", "run_len", "head_slot", "rpos", "res_new_slot",
              "blob"):
        ref = getattr(plans["numpy_s"], f)
        for name in ("native_s", "sharded_s"):
            if not np.array_equal(getattr(plans[name], f), ref):
                raise AssertionError(f"{name[:-2]} walker differs in {f}")
    out["n_ops"] = len(batch.op_kind)
    return out


def ring_phase(torch, M, card: str, device=None, base_n: int = BASE_LEN,
               n_batches: int = RING_BATCHES, n_actors: int = RING_ACTORS,
               ops: int = OPS_PER_CHANGE, reps: int = RING_REPS) -> dict:
    """bench.py --pipeline's stream at full width: one warm-up stream,
    `reps` timed streams (depth 4, in-place commits, eager
    materialization), one stream without in-place commits and one serial
    stream; every text against the independent reference. Raises on any
    failed check."""
    run = ops // 2
    batches = ring_batches(M, base_n, n_batches, n_actors, ops)
    total_ops = sum(b.n_ops for b in batches)
    n_vis = base_n + n_batches * n_actors * run
    want = sha(expected_stream_text(base_n, n_actors, run, n_batches))
    cuda = torch.device(device or "cuda").type == "cuda"

    def text_of(doc, label):
        got = sha(doc.text())
        if got != want:
            raise AssertionError(f"{label} text differs from the reference")
        return got

    doc, rec = ring_stream(torch, M, batches, base_n, device, donate=True)
    check_ring(rec, n_batches, n_vis, cuda)
    text_of(doc, "warm-up stream")
    del doc
    timed = []
    for r in range(reps):
        doc, rec = ring_stream(torch, M, batches, base_n, device,
                               donate=True)
        check_ring(rec, n_batches, n_vis, cuda)
        if r in (0, reps - 1):
            text_of(doc, f"timed stream {r}")
        if doc._store is None or not doc._store.holds(doc._dev):
            raise AssertionError("the in-place stream's tables left their "
                                 "store")
        timed.append(rec)
        del doc
    doc, plain = ring_stream(torch, M, batches, base_n, device, donate=False)
    check_ring(plain, n_batches, n_vis, cuda)
    text_of(doc, "donate=False stream")
    del doc
    doc, serial = serial_stream(torch, M, batches, base_n, device)
    if serial["n_vis"] != n_vis:
        raise AssertionError(f"serial stream n_vis {serial['n_vis']}")
    text_of(doc, "serial stream")
    del doc
    peak_inplace = max(r["peak"] for r in timed)
    if peak_inplace > plain["peak"]:
        raise AssertionError(
            f"in-place commits peaked at {peak_inplace} bytes, above the "
            f"out-of-place stream's {plain['peak']}")
    walkers = time_walkers(M, batches[0], base_n)

    rates = [total_ops / r["s"] for r in timed]
    mid = min(timed, key=lambda r: abs(r["s"] - float(np.median(
        [t["s"] for t in timed]))))
    out = {
        "ops": total_ops, "n_vis": n_vis, "depth": RING_DEPTH,
        "reps": reps, "ops_per_s_median": float(np.median(rates)),
        "ops_per_s_min": min(rates), "ops_per_s_max": max(rates),
        "stream_s": [r["s"] for r in timed],
        "stream_s_donate_false": plain["s"],
        "stats": mid["stats"], "launches": mid["launches"],
        "shapes": mid["shapes"], "detections": mid["detections"],
        "native_walks": mid["walks"],
        "peak_mib_inplace": peak_inplace / 2**20,
        "peak_mib_donate_false": plain["peak"] / 2**20,
        "serial_terms": serial["terms"], "walkers": walkers,
        "text_sha256": want[:16]}
    log(f"ring ({card}): median {out['ops_per_s_median']:.0f} ops/s "
        f"(range {out['ops_per_s_min']:.0f}-{out['ops_per_s_max']:.0f}) "
        f"over {reps} streams of {total_ops} ops; donate=False stream "
        f"{plain['s']:.4f} s; peak device memory {out['peak_mib_inplace']:.1f}"
        f" MiB in place vs {out['peak_mib_donate_false']:.1f} MiB; serial "
        f"terms {serial['terms']}; walkers {walkers}; text sha256 "
        f"{want[:16]} for the reference, the timed, donate=False and "
        f"serial streams")
    log("ring record: " + json.dumps(dict(out, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in out["shapes"].items()})))
    return out


# --- the map document --------------------------------------------------------

def map_key(a: int, j: int) -> str:
    return f"k{a:04d}-{j:04d}"


def map_round1(M, n_actors: int, per: int):
    """n_actors actors each setting their own `per` keys to inline ints:
    uncontended sets, the device fast path. Returns (batch, reference)."""
    actors = [f"m{a:04d}" for a in range(n_actors)]
    keys = [map_key(a, j) for a in range(n_actors) for j in range(per)]
    n = n_actors * per
    vals = (np.arange(n, dtype=np.int64) * 7919) % 2_000_003
    no_deps: dict = {}
    batch = M.MapChangeBatch(
        obj_id="map", actors=actors, seqs=np.ones(n_actors, np.int32),
        deps=[no_deps] * n_actors, messages=[None] * n_actors,
        op_change=np.repeat(np.arange(n_actors, dtype=np.int32), per),
        op_kind=np.full(n, M.C.KIND_SET, np.int8),
        op_key=np.arange(n, dtype=np.int32), op_value=vals,
        key_table=keys, value_pool=[])
    return batch, dict(zip(keys, vals.tolist()))


def map_round2(n_actors: int):
    """About 3 * n_actors ops on the host slow path: two actors overwrite
    one key of every actor concurrently (conflicts), one deletes a key of
    half of them, and a counter actor creates n_actors / 4 counters and
    increments each. 'c' sorts before the round-1 actors: a rank remap.
    Returns (wire changes, the reference's updates, deleted keys)."""
    frontier = {f"m{a:04d}": 1 for a in range(n_actors)}
    changes = [{"actor": f"x-{x}", "seq": 1, "deps": frontier, "ops": [
        {"action": "set", "obj": "map", "key": map_key(a, 0),
         "value": 5_000_000 + 10 * a + x} for a in range(n_actors)]}
        for x in range(2)]
    changes.append({"actor": "y", "seq": 1, "deps": frontier, "ops": [
        {"action": "del", "obj": "map", "key": map_key(a, 1)}
        for a in range(n_actors // 2)]})
    n_ctr = n_actors // 4
    changes.append({"actor": "c", "seq": 1, "deps": {}, "ops": [
        {"action": "set", "obj": "map", "key": f"ctr-{i:04d}", "value": 10,
         "datatype": "counter"} for i in range(n_ctr)]})
    changes.append({"actor": "c", "seq": 2, "deps": {"c": 1}, "ops": [
        {"action": "inc", "obj": "map", "key": f"ctr-{i:04d}", "value": i}
        for i in range(n_ctr)]})
    updates = {map_key(a, 0): 5_000_000 + 10 * a + 1 for a in range(n_actors)}
    updates.update({f"ctr-{i:04d}": 10 + i for i in range(n_ctr)})
    deleted = [map_key(a, 1) for a in range(n_actors // 2)]
    return changes, updates, deleted


def drive_map(torch, M, device, n_actors: int, per: int):
    """The two map rounds on a DeviceMapDoc; returns (doc, record)."""
    sync = (torch.cuda.synchronize if torch.device(device or "cuda").type
            == "cuda" else (lambda: None))
    batch, ref1 = map_round1(M, n_actors, per)
    changes, updates, deleted = map_round2(n_actors)
    doc = M.DeviceMapDoc("map", device=device)
    d0 = dict(doc._acct)
    t0 = time.perf_counter()
    doc.apply_batch(batch)
    sync()
    round1_s = time.perf_counter() - t0
    d1 = dict(doc._acct)
    after1 = doc.to_dict()
    conflicts1 = len(doc.conflicts)
    t0 = time.perf_counter()
    doc.apply_changes(changes)
    sync()
    round2_s = time.perf_counter() - t0
    ref2 = dict(ref1)
    ref2.update(updates)
    for k in deleted:
        del ref2[k]
    return doc, {"round1_s": round1_s, "round2_s": round2_s,
                 "round1_ops": len(batch.op_kind),
                 "round2_ops": sum(len(c["ops"]) for c in changes),
                 "round1_dispatches": d1["dispatches"] - d0["dispatches"],
                 "round1_syncs": d1["syncs"] - d0["syncs"],
                 "round1_ok": after1 == ref1 and conflicts1 == 0,
                 "ref2": ref2}


def map_tables(doc) -> dict:
    n = len(doc.key_table)
    return {k: v[:n].cpu().numpy() for k, v in doc._ensure_dev().items()}


def map_phase(torch, M, card: str, device=None, n_actors: int = MAP_ACTORS,
              per: int = MAP_KEYS_PER_ACTOR) -> dict:
    """A DeviceMapDoc holding n_actors * per keys: round 1 on the device
    fast path, round 2 on the host slow path; the result against a CPU run
    of the port and a plain-dict reference. Raises on any failed check."""
    doc, rec = drive_map(torch, M, device, n_actors, per)
    cpu_doc, _ = drive_map(torch, M, "cpu", n_actors, per)
    if not rec["round1_ok"]:
        raise AssertionError("map round 1 differs from the plain dict or "
                             "minted conflicts")
    if rec["round1_dispatches"] != 1 or rec["round1_syncs"] != 1:
        raise AssertionError("map round 1 left the one-program fast path: "
                             f"{rec['round1_dispatches']} dispatches, "
                             f"{rec['round1_syncs']} syncs")
    got = doc.to_dict()
    if got != rec["ref2"] or got != cpu_doc.to_dict():
        raise AssertionError("map round 2 differs from the reference or "
                             "the CPU run")
    if len(doc) != len(rec["ref2"]) or doc.conflicts != cpu_doc.conflicts:
        raise AssertionError("map length or conflicts differ")
    for a in (0, n_actors // 2, n_actors - 1):
        # the winner x-1 holds the key; the concurrent loser is its conflict
        want = {"x-0": 5_000_000 + 10 * a}
        if doc.conflicts_for(map_key(a, 0)) != want:
            raise AssertionError(f"conflicts of {map_key(a, 0)}: "
                                 f"{doc.conflicts_for(map_key(a, 0))}")
    if doc.conflicts_for(map_key(0, 2)) is not None:
        raise AssertionError("an uncontended key shows a conflict")
    tg, tc = map_tables(doc), map_tables(cpu_doc)
    for k in tg:
        if not np.array_equal(tg[k], tc[k]):
            raise AssertionError(f"map table {k} differs from the CPU run")
    out = {k: v for k, v in rec.items() if k != "ref2"}
    out.update(keys=len(doc.key_table), live=len(doc),
               conflicted=len(doc.conflicts))
    log(f"map ({card}): round 1 {out['round1_ops']} fast-path sets "
        f"{out['round1_s']:.4f} s, round 2 {out['round2_ops']} slow-path "
        f"ops {out['round2_s']:.4f} s; {out['keys']} keys, {out['live']} "
        f"live, {out['conflicted']} conflicted; equal to the CPU run and "
        f"the reference")
    return out


# --- the multi-document tier (bench.py measure_fused and measure_sharded,
# benchmarks/run_all.py config3_docset) --------------------------------------

def stack_text_round(doc_ids, seq: int, base_ctr: int, ops_per_doc: int):
    """One serving round for a text population (bench.py
    _sharded_text_round): every doc receives one causally-ready change
    appending an ins+set run."""
    out = {}
    run = ops_per_doc // 2
    for obj in doc_ids:
        ops, key = [], ("_head" if seq == 1 else f"a:{base_ctr - 1}")
        for k in range(run):
            ctr = base_ctr + k
            ops.append({"action": "ins", "obj": obj, "key": key,
                        "elem": ctr})
            ops.append({"action": "set", "obj": obj, "key": f"a:{ctr}",
                        "value": chr(97 + ctr % 26)})
            key = f"a:{ctr}"
        out[obj] = [{"actor": "a", "seq": seq, "deps": {}, "ops": ops}]
    return out


def stack_map_round(doc_ids, seq: int, key_space: int, ops_per_doc: int,
                    counter: bool = False):
    """One serving round for a map population (bench.py
    _sharded_map_round): `ops_per_doc` register writes rotating through
    the key space; with `counter`, one `inc` of the doc's counter too."""
    out = {}
    for di, obj in enumerate(doc_ids):
        ops = [{"action": "set", "obj": obj,
                "key": f"k{(seq * 7 + di + j) % key_space}",
                "value": seq * 100 + j} for j in range(ops_per_doc)]
        if counter:
            ops.append({"action": "inc", "obj": obj, "key": "cnt",
                        "value": 1})
        out[obj] = [{"actor": "a", "seq": seq, "deps": {}, "ops": ops}]
    return out


def fused_stream(text_ids, map_ids, key_space, n_rounds, ops, n_reps):
    """bench.py measure_fused's stream: a seed round (64 text ops, 64 map
    ops and a counter per map doc), then n_reps reps of n_rounds rounds
    of `ops` ops per doc plus one counter `inc` per map doc."""
    seed = stack_text_round(text_ids, 1, 1, 64)
    seed.update(stack_map_round(map_ids, 1, key_space, 64))
    for obj in map_ids:
        seed[obj][0]["ops"].append({"action": "set", "obj": obj,
                                    "key": "cnt", "value": 0,
                                    "datatype": "counter"})
    reps = []
    for rep in range(n_reps):
        seq0 = 2 + rep * n_rounds
        base = 33 + (seq0 - 2) * (ops // 2)
        rounds = []
        for r in range(n_rounds):
            chunk = stack_text_round(text_ids, seq0 + r,
                                     base + (ops // 2) * r, ops)
            chunk.update(stack_map_round(map_ids, seq0 + r, key_space, ops,
                                         counter=True))
            rounds.append(chunk)
        reps.append(rounds)
    return seed, reps


def shard_stream(text_ids, map_ids, key_space, n_rounds, n_reps):
    """bench.py measure_sharded's lane stream: map docs seeded with their
    whole key space then rounds of 2 ops per doc; text docs seeded with
    64 ops then rounds of 4 ops; both populations in every round."""
    seed = stack_text_round(text_ids, 1, 1, 64)
    seed.update(stack_map_round(map_ids, 1, key_space, key_space))
    reps = []
    for rep in range(n_reps):
        seq0 = 2 + rep * n_rounds
        base = 33 + (seq0 - 2) * 2
        rounds = []
        for r in range(n_rounds):
            chunk = stack_text_round(text_ids, seq0 + r, base + 2 * r, 4)
            chunk.update(stack_map_round(map_ids, seq0 + r, key_space, 2))
            rounds.append(chunk)
        reps.append(rounds)
    return seed, reps


def run_stacked(torch, M, device, text_ids, map_ids, text_cap, map_cap,
                seed, reps, warmup: int = 1):
    """Drive a stacked population through `apply_stacked`: the seed round,
    `warmup` untimed reps, then the timed reps, each apply checked stacked
    and within its round budget. The kernel counts are set to 0 just
    before the timed reps and read just after. Returns (docs, record)."""
    docs = {d: M.DeviceTextDoc(d, capacity=text_cap, device=device)
            for d in text_ids}
    docs.update({d: M.DeviceMapDoc(d, capacity=map_cap, device=device)
                 for d in map_ids})
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def apply(chunk):
        st = M.stacked.apply_stacked([(docs[k], v) for k, v in chunk.items()])
        if not st or not st["fused"]:
            raise AssertionError(f"an apply left the stacked path: {st}")
        M.stacked.assert_round_budget(st)
        return st

    apply(seed)
    for rounds in reps[:warmup]:
        for chunk in rounds:
            apply(chunk)
    sync()
    M.S.reset_launches()
    times, rates, stats = [], [], []
    for rounds in reps[warmup:]:
        admitted = 0
        t0 = time.perf_counter()
        for chunk in rounds:
            stats.append(apply(chunk))
            admitted += sum(len(c["ops"]) for v in chunk.values()
                            for c in v)
        sync()
        dt = time.perf_counter() - t0
        times.append(dt)
        rates.append(admitted / dt)
    launches = dict(M.S.launches)
    shapes = {k: dict(v) for k, v in M.S.launch_shapes.items()}
    return docs, {
        "stats": stats, "launches": launches, "shapes": shapes,
        "times": times, "rates": rates,
        "text_passes": sum(st["passes"] for st in stats if st["text_docs"]),
        "passes": sum(st["passes"] for st in stats),
        "dispatches": sum(st["dispatches"] for st in stats),
        "syncs": sum(st["syncs"] for st in stats)}


def stacked_state(docs) -> dict:
    out = {}
    for k, d in docs.items():
        out[k] = d.text() if hasattr(d, "text") else d.to_dict()
    return out


def stacked_phase(torch, M, card: str, label: str, device=None,
                  text_ids=(), map_ids=(), text_cap: int = 1024,
                  map_cap: int = 256, stream=None) -> dict:
    """One stacked population on the card and the same stream on the CPU:
    every apply stacked, fused and within budget, `multi_scan` once per
    text pass at (D * 6, N), and the final texts, map values and counters
    equal the CPU run's. Raises on any failed check."""
    seed, reps = stream
    docs, rec = run_stacked(torch, M, device, text_ids, map_ids, text_cap,
                            map_cap, seed, reps)
    cuda = torch.device(device or "cuda").type == "cuda"
    if cuda:
        want_shapes = {(len(text_ids) * 6, n)
                       for (_k, n) in rec["shapes"]["multi_scan"]}
        if (rec["launches"]["multi_scan"] != rec["text_passes"]
                or set(rec["shapes"]["multi_scan"]) != want_shapes):
            raise AssertionError(
                f"{label}: multi_scan launched {rec['launches']} at "
                f"{rec['shapes']} for {rec['text_passes']} text passes")
    got = stacked_state(docs)
    cpu_docs, _ = run_stacked(torch, M, "cpu", text_ids, map_ids, text_cap,
                              map_cap, seed, reps)
    if got != stacked_state(cpu_docs):
        raise AssertionError(f"{label}: the card's state differs from the "
                             "CPU run")
    if map_ids and "cnt" in got[map_ids[0]]:
        n_inc = sum(len(r) for r in reps)
        if any(got[m]["cnt"] != n_inc for m in map_ids):
            raise AssertionError(f"{label}: a counter missed an inc")
    n_applies = len(rec["stats"])
    out = {
        "text_docs": len(text_ids), "map_docs": len(map_ids),
        "text_cap": text_cap, "map_cap": map_cap,
        "applies": n_applies, "reps": len(rec["times"]),
        "ops_per_s_median": float(np.median(rec["rates"])),
        "ops_per_s_min": min(rec["rates"]), "ops_per_s_max": max(rec["rates"]),
        "rep_s": rec["times"],
        "programs_per_pass": rec["dispatches"] / rec["passes"],
        "syncs_per_apply": rec["syncs"] / n_applies,
        "passes_per_apply": rec["passes"] / n_applies,
        "launches": rec["launches"], "shapes": rec["shapes"],
        "cells": max(text_cap, map_cap) * (5 * len(map_ids)
                                           + 9 * len(text_ids))}
    log(f"{label} ({card}): median {out['ops_per_s_median']:.0f} admitted "
        f"wire ops/s (range {out['ops_per_s_min']:.0f}-"
        f"{out['ops_per_s_max']:.0f}) over {out['reps']} reps of "
        f"{n_applies // max(out['reps'], 1)} applies; "
        f"{out['programs_per_pass']:.2f} round programs per pass, "
        f"{out['syncs_per_apply']:.2f} syncs per apply; launches "
        f"{rec['launches']} at {rec['shapes']}; equal to the CPU run")
    log(f"{label} record: " + json.dumps(dict(out, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in out["shapes"].items()})))
    return out


def docset_batch(TB, C, obj_id: str, seed: int, n_actors: int, run: int):
    """benchmarks/run_all.py config3_docset's doc_batch: n_actors
    concurrent typing runs from the head of an empty doc."""
    n_ops = n_actors * run * 2
    actors = [f"actor-{i:03d}" for i in range(n_actors)]
    op_change = np.repeat(np.arange(n_actors, dtype=np.int32), run * 2)
    kind = np.tile(np.array([C.KIND_INS, C.KIND_SET], np.int8),
                   n_actors * run)
    ta = np.repeat(np.arange(n_actors, dtype=np.int32), run * 2)
    tc = np.zeros(n_ops, np.int32)
    pa = np.zeros(n_ops, np.int32)
    pc = np.zeros(n_ops, np.int32)
    val = np.zeros(n_ops, np.int64)
    ctrs = np.arange(1, run + 1, dtype=np.int32)
    for a in range(n_actors):
        s = a * run * 2
        tc[s: s + 2 * run: 2] = ctrs
        tc[s + 1: s + 2 * run: 2] = ctrs
        pa[s] = C.HEAD_PARENT
        pa[s + 2: s + 2 * run: 2] = a
        pc[s + 2: s + 2 * run: 2] = ctrs[:-1]
        val[s + 1: s + 2 * run: 2] = 97 + ((a + seed) % 26)
    return TB(
        obj_id=obj_id, actors=actors, seqs=np.ones(n_actors, np.int32),
        deps=[{}] * n_actors, messages=[None] * n_actors,
        op_change=op_change, op_kind=kind, op_target_actor=ta,
        op_target_ctr=tc, op_parent_actor=pa, op_parent_ctr=pc,
        op_value=val, actor_table=actors, value_pool=[])


def docset_general_round(ids, n_general: int, run: int):
    """The round after the bulk build: the first n_general docs each get
    a change that needs the general path (deletes of six elements and one
    overwrite — no run), so they graduate and merge through the stacked
    executor together; every other doc appends a typing run on the fast
    tier."""
    out = {}
    for d, obj in enumerate(ids):
        if d < n_general:
            ops = [{"action": "del", "obj": obj, "key": f"actor-000:{j}"}
                   for j in range(1, 7)]
            ops.append({"action": "set", "obj": obj, "key": "actor-001:1",
                        "value": "Z"})
            out[obj] = [{"actor": "z-edit", "seq": 1,
                         "deps": {"actor-000": 1, "actor-001": 1},
                         "ops": ops}]
        else:
            ops, key = [], f"actor-000:{run}"
            for k in range(4):
                ctr = 1000 + k
                ops.append({"action": "ins", "obj": obj, "key": key,
                            "elem": ctr})
                ops.append({"action": "set", "obj": obj,
                            "key": f"actor-000:{ctr}", "value": "+"})
                key = f"actor-000:{ctr}"
            out[obj] = [{"actor": "actor-000", "seq": 2, "deps": {},
                         "ops": ops}]
    return out


def docset_phase(torch, M, card: str, device=None, n_docs: int = DOCSET_DOCS,
                 n_actors: int = DOCSET_ACTORS, chars: int = DOCSET_CHARS,
                 reps: int = DOCSET_REPS) -> dict:
    """benchmarks/run_all.py config3_docset at its defaults: the bulk build
    on the stacked fast tier plus a planned texts(), timed over fresh
    runs; then the corrupted-mirror heal (the row form of
    fused_segment_scans, one launch over the stacked rows), and a round
    whose graduated docs merge through apply_stacked — every text equal
    to the CPU run's. Raises on any failed check."""
    ids = [f"d{d}" for d in range(n_docs)]
    batches = {f"d{d}": docset_batch(M.TB, M.C, f"d{d}", d, n_actors, chars)
               for d in range(n_docs)}
    n_ops = sum(b.n_ops for b in batches.values())
    cap = n_actors * chars + 64
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def build(dev):
        ds = M.DeviceTextDocSet(ids, capacity=cap, device=dev)
        ds.apply_batches(batches)
        return ds, ds.texts()

    cpu_ds, cpu_texts = build("cpu")
    if sum(len(t) for t in cpu_texts.values()) != n_docs * n_actors * chars:
        raise AssertionError("docset CPU run: wrong total length")
    times = []
    build_launches = build_shapes = None
    for r in range(1 + reps):
        sync()
        M.S.reset_launches()
        t0 = time.perf_counter()
        ds, texts = build(device)
        sync()
        dt = time.perf_counter() - t0
        if r == 0:
            build_launches = dict(M.S.launches)
            build_shapes = {k: dict(v) for k, v in M.S.launch_shapes.items()}
        else:
            times.append(dt)
        if texts != cpu_texts:
            raise AssertionError(f"docset run {r}: texts differ from the "
                                 "CPU run")
    if cuda and (build_launches["multi_scan"] != 1
                 or set(build_shapes["multi_scan"])
                 != {(n_docs * 5, M.bucket(n_actors * chars, 256))}):
        raise AssertionError(f"docset build: multi_scan launched "
                             f"{build_launches} at {build_shapes}")

    # the heal: corrupt one row's mirror; the next texts() serves every row
    # through the self-contained program (one row-form launch)
    for s_ds in (ds, cpu_ds):
        m = s_ds._meta[1].mirror
        bad = type(m)(np.append(m.heads, 3), np.append(m.par, 2),
                      np.append(m.hctr, 99), np.append(m.hactor, 0))
        bad.heads.sort()
        s_ds._meta[1].mirror = bad
        s_ds._codes_cache = None
    heals = heal_watch(logging)
    sync()
    M.S.reset_launches()
    healed = ds.texts()
    heal_launches = dict(M.S.launches)
    heal_shapes = {k: dict(v) for k, v in M.S.launch_shapes.items()}
    if healed != cpu_texts or cpu_ds.texts() != cpu_texts:
        raise AssertionError("docset heal: texts changed")
    if not any("diverged" in msg for msg in heals.records):
        raise AssertionError("docset heal: the corrupted mirror went unseen")
    C_rows = ds._cap
    if cuda and (heal_launches["fused_segment_scans"] != 1
                 or set(heal_shapes["fused_segment_scans"])
                 != {(n_docs, C_rows)}):
        raise AssertionError(f"docset heal: fused_segment_scans launched "
                             f"{heal_launches} at {heal_shapes}")
    ds._codes_cache = None
    M.S.reset_launches()
    n_warn = len(heals.records)
    if ds.texts() != cpu_texts or len(heals.records) != n_warn or \
            M.S.launches["fused_segment_scans"]:
        raise AssertionError("docset: the call after the heal was not "
                             "planned")
    logging.getLogger("automerge_tpu_torch.engine").removeHandler(heals)

    # graduated docs merge through the stacked executor on the card
    general = docset_general_round(ids, 3, chars)
    tb = {o: M.TB.from_changes(c, o) for o, c in general.items()}
    M.stacked.LAST_STATS.clear()
    M.S.reset_launches()
    ds.apply_batches(tb)
    sync()
    gen_stats = dict(M.stacked.LAST_STATS)
    gen_launches = dict(M.S.launches)
    gen_shapes = {k: dict(v) for k, v in M.S.launch_shapes.items()}
    cpu_ds.apply_batches({o: M.TB.from_changes(c, o)
                          for o, c in general.items()})
    if not gen_stats or gen_stats["text_docs"] != 3:
        raise AssertionError(f"docset: the graduated docs did not take "
                             f"apply_stacked: {gen_stats}")
    if cuda and gen_launches["multi_scan"] < 2:
        raise AssertionError(f"docset general round: launches "
                             f"{gen_launches}")
    after = ds.texts()
    if after != cpu_ds.texts() or len(ds._overlay) != 3:
        raise AssertionError("docset general round differs from the CPU "
                             "run")
    out = {
        "docs": n_docs, "actors": n_actors, "chars": chars, "ops": n_ops,
        "capacity": cap, "reps": reps,
        "build_s": times, "build_s_median": float(np.median(times)),
        "ops_per_s_median": n_ops / float(np.median(times)),
        "docs_per_s_median": n_docs / float(np.median(times)),
        "total_chars": sum(len(t) for t in texts.values()),
        "launches": {k: build_launches[k] + heal_launches[k]
                     + gen_launches[k] for k in build_launches},
        "shapes": {k: {sh: build_shapes[k].get(sh, 0)
                       + heal_shapes[k].get(sh, 0)
                       + gen_shapes[k].get(sh, 0)
                       for sh in set(build_shapes[k]) | set(heal_shapes[k])
                       | set(gen_shapes[k])} for k in build_shapes},
        "heal_launches": heal_launches,
        "general_stats": gen_stats}
    log(f"docset ({card}): {n_docs} docs x {n_actors} actors x {chars} "
        f"chars, {n_ops} ops: build + planned texts() median "
        f"{out['build_s_median']:.4f} s over {reps} fresh runs "
        f"({out['ops_per_s_median']:.0f} ops/s, "
        f"{out['docs_per_s_median']:.0f} docs/s), {out['total_chars']} "
        f"chars; heal launches {heal_launches} at {heal_shapes}; general round "
        f"{gen_stats['text_docs']} graduated docs stacked, launches "
        f"{gen_launches}; equal to the CPU run")
    log("docset record: " + json.dumps(dict(out, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in out["shapes"].items()})))
    return out


def trellis_changes(am, oracle, n_actors: int, n_cards: int, backend):
    """benchmarks/run_all.py trellis_changes through the port's API: a
    board of n_cards cards x 3 tasks made on `backend`, then n_actors
    peers minted on the oracle backend `oracle`, each doing one task
    append, retitle or task delete. Returns (base doc, changes, n_ops)."""
    base = am.change(am.init({"actorId": "base", "backend": backend}),
                     lambda d: d.update({"cards": [
                         {"title": f"card{i}",
                          "tasks": [f"t{j}" for j in range(3)]}
                         for i in range(n_cards)]}))
    base_changes = am.get_all_changes(base)
    changes = []
    for a in range(n_actors):
        peer = am.apply_changes(
            am.init({"actorId": f"actor-{a:05d}", "backend": oracle}),
            base_changes)
        k = a % n_cards
        if a % 3 == 0:
            peer2 = am.change(peer, lambda d, k=k, a=a: d["cards"][k]
                              ["tasks"].append(f"new-{a}"))
        elif a % 3 == 1:
            peer2 = am.change(peer, lambda d, k=k, a=a: d["cards"][k]
                              .__setitem__("title", f"retitled-{a}"))
        else:
            peer2 = am.change(peer, lambda d, k=k: d["cards"][k]["tasks"]
                              .__delitem__(0))
        changes.extend(am.get_changes(base, peer2))
    return base, changes, sum(len(c["ops"]) for c in changes)


def _canon(am, doc) -> str:
    return json.dumps(am.to_json(doc), sort_keys=True, default=str)


def api_trellis(torch, M, card: str, device, n_actors: int, reps: int,
                n_cards: int = API_CARDS) -> dict:
    """api-a, cfg4 (benchmarks/run_all.py config4_trellis, merged as
    benchmarks/cfg4_smoke.py does): each rep loads the saved board afresh
    on `device` and merges every actor's change with one apply_changes.
    Every merge must stay on the device tier (no graduation), stack within
    its round budget, and give the oracle's and the CPU backend's
    document and save() bytes."""
    am, dev_be = M.am, M.device_backend
    backend = am.backend.backend_for(device)
    oracle = am.backend.facade.Backend
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    base, changes, n_ops = trellis_changes(am, oracle, n_actors, n_cards,
                                           backend)
    mint_s = time.perf_counter() - t0
    saved = am.save(base)

    def merge(be, actor):
        fresh = am.load(saved, {"actorId": actor, "backend": be})
        M.stacked.LAST_STATS.clear()
        dev_be.GRADUATION_STATS.clear()
        sync()
        with M.accounting.track() as tr:
            t = time.perf_counter()
            merged = am.apply_changes(fresh, changes)
            sync()
            dt = time.perf_counter() - t
        st = dict(M.stacked.LAST_STATS)
        if not isinstance(am.frontend.get_backend_state(merged),
                          dev_be.DeviceBackendState):
            raise AssertionError("api-a: the merge left the device tier")
        if dev_be.GRADUATION_STATS:
            raise AssertionError(f"api-a: graduated "
                                 f"{dev_be.GRADUATION_STATS}")
        if not st:
            raise AssertionError("api-a: the merge did not stack")
        M.stacked.assert_round_budget(st)
        return merged, dt, st, tr.thread_stats

    merge(backend, "merger")                     # warm-up
    times, stats, syncs = [], [], []
    for r in range(reps):
        merged, dt, st, acct = merge(backend, "merger")
        times.append(dt)
        stats.append(st)
        syncs.append(acct["syncs"])
    cpu_merged, _, cpu_st, _ = merge(am.backend.backend_for("cpu"), "merger")
    ref = am.apply_changes(am.init({"actorId": "merger", "backend": oracle}),
                           am.get_all_changes(base) + changes)
    if not (_canon(am, merged) == _canon(am, cpu_merged)
            == _canon(am, ref)):
        raise AssertionError("api-a: the merged board differs from the CPU "
                             "backend's or the oracle's")
    if not am.save(merged) == am.save(cpu_merged) == am.save(ref):
        raise AssertionError("api-a: save() bytes differ")
    if len(am.to_json(merged)["cards"]) != n_cards:
        raise AssertionError("api-a: wrong number of cards")
    rates = [n_ops / t for t in times]
    out = {"actors": n_actors, "cards": n_cards, "changes": len(changes),
           "ops": n_ops, "reps": reps, "mint_s": mint_s,
           "ops_per_s_median": float(np.median(rates)),
           "ops_per_s_min": min(rates), "ops_per_s_max": max(rates),
           "merge_s": times,
           "programs_per_pass": stats[-1]["dispatches"]
           / stats[-1]["passes"],
           "passes": stats[-1]["passes"], "rounds": stats[-1]["rounds"],
           "syncs_per_apply": float(np.median(syncs)),
           "stacked": {k: v for k, v in stats[-1].items()
                       if isinstance(v, (int, float, bool))}}
    log(f"api-a cfg4 trellis ({card}): {n_actors} actors, {n_ops} ops in "
        f"{len(changes)} changes; median {out['ops_per_s_median']:.0f} ops/s"
        f" (range {out['ops_per_s_min']:.0f}-{out['ops_per_s_max']:.0f}) "
        f"over {reps} merges; {out['programs_per_pass']:.2f} round "
        f"programs per pass, {out['passes']} passes, "
        f"{out['syncs_per_apply']:.0f} syncs per apply; minted in "
        f"{mint_s:.2f} s; equal to the oracle and the CPU backend")
    return out


def api_latency(torch, M, card: str, device, n_base: int, n_changes: int,
                skip: int = API_SKIP) -> dict:
    """api-b, cfg7 (benchmarks/run_all.py config7_interactive_latency): a
    n_base-char Text made through change(), then n_changes local 10-char
    inserts through change(), each timed whole (full API) and inside the
    backend's apply_local_change (backend only); then one get_patch read,
    which flushes the write-behind rounds into the engine. The text must
    equal the expected string. Returns the record and the final text."""
    am = M.am
    base_ns = am.backend.backend_for(device)
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    be_s: list = []

    def timed_alc(state, request):
        t = time.perf_counter()
        out = base_ns.apply_local_change(state, request)
        be_s.append(time.perf_counter() - t)
        return out
    timed = type("TimedBackend", (base_ns,), {
        "apply_local_change": staticmethod(timed_alc)})
    t = time.perf_counter()
    doc = am.change(am.init({"actorId": "user", "backend": timed}),
                    lambda d: d.__setitem__("t", am.Text("x" * n_base)))
    sync()
    create_s = time.perf_counter() - t
    be_s.clear()
    lat = []
    want = "x" * n_base
    for i in range(n_changes):
        t = time.perf_counter()
        doc = am.change(doc, lambda d, i=i: d["t"].insert_at(
            5000 + 11 * i, *"helloworld"))
        lat.append(time.perf_counter() - t)
        at = 5000 + 11 * i
        want = want[:at] + "helloworld" + want[at:]
    state = am.frontend.get_backend_state(doc)
    pending = len(state._core.pending)
    t = time.perf_counter()
    patch = base_ns.get_patch(state)
    sync()
    flush_s = time.perf_counter() - t
    text = "".join(d["value"] for d in patch["diffs"]
                   if d["action"] == "insert")
    if text != want or str(doc["t"]) != want:
        raise AssertionError("api-b: the text differs from the expected "
                             "string")

    def pcts(series):
        w = np.asarray(series[skip:]) * 1e3
        return float(np.percentile(w, 50)), float(np.percentile(w, 99))
    (p50, p99), (be50, be99) = pcts(lat), pcts(be_s)
    out = {"chars": n_base, "changes": n_changes, "skip": skip,
           "create_s": create_s, "api_p50_ms": p50, "api_p99_ms": p99,
           "backend_p50_ms": be50, "backend_p99_ms": be99,
           "pending_before_flush": pending, "flush_read_s": flush_s}
    log(f"api-b cfg7 interactive ({card}): {n_base} chars, {n_changes} "
        f"10-char inserts; full API p50 {p50:.4f} ms p99 {p99:.4f} ms, "
        f"backend p50 {be50:.4f} ms p99 {be99:.4f} ms; {pending} rounds "
        f"pending before the get_patch read ({flush_s:.4f} s); create "
        f"{create_s:.4f} s; text as expected")
    return out, text


def api_graduation(torch, M, card: str, device) -> dict:
    """api-c: one delivery outside the device grammar (an `ins` on a map
    object) graduates the lineage to the oracle, once; the result equals
    the oracle's, and the document before it stays on the device."""
    am, dev_be = M.am, M.device_backend
    facade = am.backend.facade
    backend = am.backend.backend_for(device)
    doc = am.change(am.init({"actorId": "alice", "backend": backend}),
                    lambda d: d.update({"m": {"k": 1}, "t": am.Text("ab")}))
    state = am.frontend.get_backend_state(doc)
    odd = {"actor": "zed", "seq": 1, "deps": dict(state.clock),
           "ops": [{"action": "ins", "obj": am.get_object_id(doc["m"]),
                    "key": "_head", "elem": 1}]}
    dev_be.GRADUATION_STATS.clear()
    g, patch = backend.apply_changes(state, [odd])
    o, o_patch = facade.apply_changes(
        facade.apply_changes(facade.init(), state.history())[0], [odd])
    if dev_be.GRADUATION_STATS != {"out_of_scope": 1}:
        raise AssertionError(f"api-c: {dev_be.GRADUATION_STATS}")
    if not isinstance(g, facade.BackendState):
        raise AssertionError("api-c: the lineage did not graduate")
    # (the oracle replays the history as remote changes, so only its undo
    # flags may differ)
    if (patch["diffs"] != o_patch["diffs"] or patch["clock"] != o_patch[
            "clock"] or backend.get_patch(g)["diffs"]
            != facade.get_patch(o)["diffs"]):
        raise AssertionError("api-c: the graduated result differs from the "
                             "oracle's")
    after = am.change(doc, lambda d: d["t"].insert_at(2, "c"))
    if not isinstance(am.frontend.get_backend_state(after),
                      dev_be.DeviceBackendState) or str(after["t"]) != "abc":
        raise AssertionError("api-c: the prior document left the device")
    log(f"api-c graduation ({card}): GRADUATION_STATS "
        f"{dev_be.GRADUATION_STATS}, equal to the oracle")
    return dict(dev_be.GRADUATION_STATS)


def api_phase(torch, M, card: str, device=None, n_actors: int = API_ACTORS,
              reps: int = API_REPS, n_base: int = API_TEXT,
              n_changes: int = API_CHANGES) -> dict:
    """The public API on `device`: api-a (cfg4 trellis merge), api-b (cfg7
    interactive latency, with the same session on the CPU backend) and
    api-c (graduation). The kernel counts are set to 0 before each part
    and read after it. Raises on any failed check."""
    launches = {k: 0 for k in M.S.launches}
    shapes = {k: {} for k in M.S.launches}
    by_part = {}
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def counted(part, fn):
        sync()
        M.S.reset_launches()
        out = fn()
        sync()
        by_part[part] = {k: {"x".join(map(str, sh)): n
                             for sh, n in v.items()}
                         for k, v in M.S.launch_shapes.items()}
        for k, n in M.S.launches.items():
            launches[k] += n
            for sh, c in M.S.launch_shapes[k].items():
                shapes[k][sh] = shapes[k].get(sh, 0) + c
        return out
    a = counted("api-a", lambda: api_trellis(torch, M, card, device,
                                             n_actors, reps))
    b, text = counted("api-b", lambda: api_latency(torch, M, card, device,
                                                   n_base, n_changes))
    _b_cpu, cpu_text = api_latency(torch, M, "cpu backend", "cpu", n_base,
                                   n_changes)
    if text != cpu_text:
        raise AssertionError("api-b: the card's text differs from the CPU "
                             "backend's")
    c = counted("api-c", lambda: api_graduation(torch, M, card, device))
    if cuda and not by_part["api-a"]["multi_scan"]:
        raise AssertionError("api-a: multi_scan did not launch")
    if cuda and not by_part["api-b"]["multi_scan"]:
        raise AssertionError("api-b: multi_scan did not launch")
    out = {"a": a, "b": b, "c": c, "launches": launches, "shapes": shapes,
           "launches_by_part": by_part}
    log(f"api phase launches: {launches}, by part {by_part}")
    log("api record: " + json.dumps(dict(out, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in shapes.items()})))
    return out


# --- the checkpoint tier (bench.py measure_restore, api-b, the ring) --------

def base_changes_json(obj: str, n: int) -> str:
    """bench.py _base_changes_json: one bulk change typing an n-char
    document, in the save()/wire JSON shape."""
    ops = []
    prev = "_head"
    for c in range(1, n + 1):
        ch = chr(97 + (c % 26))
        ops.append(f'{{"action":"ins","obj":"{obj}","key":"{prev}",'
                   f'"elem":{c}}}')
        ops.append(f'{{"action":"set","obj":"{obj}","key":"base:{c}",'
                   f'"value":"{ch}"}}')
        prev = f"base:{c}"
    return ('[{"actor":"base","seq":1,"deps":{},"ops":[' + ",".join(ops)
            + "]}]")


def tail_changes_json(obj: str, n_actors: int, ops_per_change: int,
                      base_n: int, seed: int = 9) -> str:
    """bench.py _tail_changes_json: n_actors concurrent typing runs over
    the base doc (everything past the checkpoint frontier)."""
    rng = np.random.default_rng(seed)
    run = ops_per_change // 2
    targets = rng.zipf(1.2, n_actors).clip(1, base_n)
    changes = []
    for a in range(n_actors):
        actor = f"tail-{a:04d}"
        ops = []
        prev = f"base:{int(targets[a])}"
        ch = chr(97 + (a % 26))
        for k in range(run):
            e = base_n + 1 + k
            ops.append(f'{{"action":"ins","obj":"{obj}","key":"{prev}",'
                       f'"elem":{e}}}')
            ops.append(f'{{"action":"set","obj":"{obj}",'
                       f'"key":"{actor}:{e}","value":"{ch}"}}')
            prev = f"{actor}:{e}"
        changes.append(f'{{"actor":"{actor}","seq":1,"deps":{{"base":1}},'
                       f'"ops":[' + ",".join(ops) + "]}")
    return "[" + ",".join(changes) + "]"


def storage_bytes(doc) -> int:
    """The bytes of the distinct storages a document's tables sit in."""
    st = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
          for t in doc._dev.values()}
    return sum(st.values())


def ckpt_engine(torch, M, card: str, device=None, base_n: int = BASE_LEN,
                tail_actors: int = CKPT_TAIL_ACTORS,
                ops: int = CKPT_TAIL_OPS, out_dir: str = None) -> dict:
    """(a) bench.py measure_restore on the port, under obs.tracing(): a
    base_n-element DeviceTextDoc built from its change log and captured;
    the full replay (decode base + tail logs, apply, _materialize,
    _scalars) against the snapshot restore (verify + stage the bundle,
    decode and apply the tail, the same read); one warm-up each, then
    min of 2 inside device_truth.steady_state. The restore's staged h2d
    bytes are exact, the footprint gauge equals the restored tables'
    storage bytes, and the restored doc read through the self-contained
    path (mirror dropped) gives the same text. Raises on any failure."""
    obs, dt, accounting = M.obs, M.dt, M.accounting
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    obj = "ckpt-text"
    t_phase = time.perf_counter()
    base_json = base_changes_json(obj, base_n)
    tail_json = tail_changes_json(obj, tail_actors, ops, base_n)
    expect = base_n + tail_actors * (ops // 2)
    with obs.tracing():
        obs.clear()
        t0_trace = obs.now()
        doc = M.DeviceTextDoc(obj, capacity=base_n + 1, device=device)
        doc.apply_batch(M.TB.from_json(base_json, obj))
        doc._materialize(with_pos=False)
        doc._scalars()
        t = time.perf_counter()
        bundle = M.ckpt.capture_engine(doc)
        capture_s = time.perf_counter() - t
        del doc

        def read(d):
            d._materialize(with_pos=False)
            n_vis = int(d._scalars()[0])
            sync()
            if n_vis != expect:
                raise AssertionError(f"checkpoint read n_vis {n_vis} != "
                                     f"{expect}")

        def full_replay():
            t = time.perf_counter()
            d = M.DeviceTextDoc(obj, capacity=base_n + 1, device=device)
            d.apply_batch(M.TB.from_json(base_json, obj))
            d.apply_batch(M.TB.from_json(tail_json, obj))
            read(d)
            return time.perf_counter() - t, d

        def snapshot_restore():
            t = time.perf_counter()
            d = M.ckpt.restore_engine(bundle, device)
            d.apply_batch(M.TB.from_json(tail_json, obj))
            read(d)
            return time.perf_counter() - t, d

        _, full_doc = full_replay()
        full_text = full_doc.text()
        del full_doc
        _, snap_doc = snapshot_restore()
        if sha(snap_doc.text()) != sha(full_text):
            raise AssertionError("snapshot restore text differs from the "
                                 "full replay's")
        del snap_doc
        with dt.steady_state() as ss:
            full_s = min(full_replay()[0] for _ in range(2))
            snap_s = min(snapshot_restore()[0] for _ in range(2))
        ss.assert_zero()
        # one restore alone: exact staged bytes, peak memory, footprint
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with accounting.track() as tr:
            t = time.perf_counter()
            d = M.ckpt.restore_engine(bundle, device)
            sync()
            restore_only_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        cap = M.bucket(base_n + 1)
        if tr.stats["h2d_bytes"] != cap * 27:
            raise AssertionError(f"restore staged {tr.stats['h2d_bytes']} "
                                 f"bytes, not {cap * 27}")
        gauge = obs.metrics_snapshot()["device_truth"]["footprint"][
            "gauges"][f"doc:{obj}"]
        if gauge != storage_bytes(d) or gauge != \
                d.device_footprint()["device_bytes"]:
            raise AssertionError(f"footprint gauge {gauge} != the restored "
                                 f"tables' storage {storage_bytes(d)}")
        if any(t.device.type != torch.device(device or "cuda").type
               for t in d._dev.values()):
            raise AssertionError("restored tables left the device")
        d.apply_batch(M.TB.from_json(tail_json, obj))
        planned = d.text()
        d.seg_mirror = None           # the self-contained read
        d._text_cache = None
        d._mat = None
        d._seg_bound = d.n_elems + 2
        contained = d.text()
        if sha(planned) != sha(full_text) or contained != planned:
            raise AssertionError("the self-contained read of the restored "
                                 "doc differs")
        del d
        trace = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            trace = os.path.join(out_dir, "checkpoint_trace.json")
            obs.write_trace(trace, since_ns=t0_trace)
            checked = M.export.validate_chrome_trace(trace)
        else:
            checked = M.export.validate_chrome_trace(
                M.export.to_chrome_trace(obs.snapshot(t0_trace),
                                         t0_ns=obs.recorder().t0_ns))
    out = {"restore_full_replay_s": full_s, "restore_snapshot_s": snap_s,
           "restore_speedup": full_s / snap_s,
           "restore_bundle_bytes": len(bundle),
           "restore_log_bytes": len(base_json) + len(tail_json),
           "restore_tail_ops": tail_actors * ops,
           "restore_h2d_bytes": tr.stats["h2d_bytes"],
           "restore_only_s": restore_only_s, "capture_s": capture_s,
           "restore_peak_mib": peak / 2**20, "footprint_gauge": gauge,
           "steady_state_builds": ss.recompiles,
           "trace": checked, "trace_file": trace,
           "text_sha256": sha(full_text)[:16],
           "wall_s": time.perf_counter() - t_phase}
    log(f"ckpt-a engine cold start ({card}): full replay "
        f"{full_s:.4f} s, snapshot restore + tail {snap_s:.4f} s "
        f"({out['restore_speedup']:.2f}x); bundle {len(bundle)} bytes, log "
        f"{out['restore_log_bytes']} bytes; restore alone "
        f"{restore_only_s:.4f} s staging {tr.stats['h2d_bytes']} h2d bytes, "
        f"peak device memory {out['restore_peak_mib']:.1f} MiB; capture "
        f"{capture_s:.4f} s; footprint gauge {gauge} = storage bytes; no "
        f"build in the timed reps; trace {checked}; text sha256 "
        f"{out['text_sha256']} (full, snapshot, self-contained); wall "
        f"{out['wall_s']:.2f} s")
    return out


def _pinned_uuids(M):
    """A deterministic uuid factory (object ids), so that the card's and
    the CPU's documents are byte-comparable."""
    import itertools
    c = itertools.count(1)
    M.uuid.set_factory(lambda: f"00000000-0000-0000-0000-{next(c):012d}")


def ckpt_api(torch, M, card: str, device, n_base: int = API_TEXT,
             n_changes: int = API_CHANGES, timed_reps: bool = True) -> dict:
    """(b) the API's checkpoint forms on api-b's document: a checkpoint
    after the creating change, 60 inserts, a delta save loaded back with
    its checkpoint, a full checkpoint restored; a flipped bit raises
    CheckpointError and the replay fallback lands the same document;
    restore timed against load(save(doc)) (unless `timed_reps` is
    false). Returns the record and the bytes the CPU backend's run must
    equal."""
    am, ckpt = M.am, M.ckpt
    backend = am.backend.backend_for(device)
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def o(actor):
        return {"actorId": actor, "backend": backend}
    _pinned_uuids(M)
    t_phase = time.perf_counter()
    try:
        doc = am.change(am.init(o("user")),
                        lambda d: d.__setitem__("t", am.Text("x" * n_base)))
        ck = am.checkpoint_doc(doc)
        for i in range(n_changes):
            doc = am.change(doc, lambda d, i=i: d["t"].insert_at(
                5000 + 11 * i, *"helloworld"))
        delta = am.save(doc, checkpoint=ck)
        back = am.load(delta, o("loader"), checkpoint=ck)
        full = am.checkpoint_doc(doc)
        rest = am.restore(full, o("restorer"))
        saved = am.save(doc)
        clock = am.frontend.get_backend_state(doc).clock
        for other, what in ((back, "delta load"), (rest, "restore")):
            if (am.to_json(other) != am.to_json(doc)
                    or am.save(other) != saved
                    or am.frontend.get_backend_state(other).clock != clock):
                raise AssertionError(f"ckpt-b: the {what} differs from the "
                                     "document")
        corrupt = bytearray(full.data)
        corrupt[len(corrupt) // 2] ^= 0x40
        try:
            am.restore(bytes(corrupt), o("bad"))
        except am.CheckpointError:
            pass
        else:
            raise AssertionError("ckpt-b: a flipped bit restored")
        fb = ckpt.restore_doc_or_replay(bytes(corrupt),
                                        am.get_all_changes(doc), o("fb"))
        if am.save(fb) != saved or am.to_json(fb) != am.to_json(doc):
            raise AssertionError("ckpt-b: the replay fallback differs")

        def timed(fn):
            fn()
            best = None
            for _ in range(2):
                sync()
                t = time.perf_counter()
                fn()
                sync()
                dt_s = time.perf_counter() - t
                best = dt_s if best is None else min(best, dt_s)
            return best
        restore_s = load_s = float("nan")
        if timed_reps:
            restore_s = timed(lambda: am.restore(full, o("r")))
            load_s = timed(lambda: am.load(saved, o("l")))
        on_device = all(
            w.doc.device.type == torch.device(device or "cuda").type
            for w in am.frontend.get_backend_state(rest)._core
            .objects.values())
        if not on_device:
            raise AssertionError("ckpt-b: the restored document left the "
                                 "device")
    finally:
        M.uuid.reset()
    out = {"chars": n_base, "changes": n_changes,
           "checkpoint_bytes": len(ck.data), "full_bytes": len(full.data),
           "delta_bytes": len(delta), "save_bytes": len(saved),
           "restore_s": restore_s, "load_s": load_s,
           "restore_vs_load": load_s / restore_s,
           "wall_s": time.perf_counter() - t_phase}
    log(f"ckpt-b api ({card}): delta save {len(delta)} bytes "
        f"({n_changes} changes) against save() {len(saved)}; checkpoint "
        f"{len(full.data)} bytes; restore {restore_s:.4f} s vs "
        f"load(save(doc)) {load_s:.4f} s ({out['restore_vs_load']:.2f}x); "
        f"delta load, restore, replay fallback equal to the document; "
        f"flipped bit refused; wall {out['wall_s']:.2f} s")
    return out, (ck.data, delta, full.data, saved)


def ring_captures(torch, M, batches, base_n: int, device, donate: bool,
                  capture: bool) -> tuple:
    """One cfg5f stream through PipelinedIngestor with an AsyncCheckpointer
    capture requested after each committed batch (none when `capture` is
    false). With in-place commits (donate) the deferred grab refuses and
    the handle's result, taken at that commit boundary, captures on the
    caller thread; without, the worker captures while the ring runs on.
    Returns (doc, record, bundles)."""
    doc = ring_doc(M, base_n, device)
    batches = fresh(batches)
    cuda = doc.device.type == "cuda"
    handles, bundles = [], []
    if capture and not donate:
        # a capture at open seeds the commit-boundary snapshot that a grab
        # racing a commit serves (without one it conflicts, cold)
        bundles.append(M.ckpt.AsyncCheckpointer.capture(doc))
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with M.ckpt.AsyncCheckpointer() as w:
        with M.PipelinedIngestor(doc, slots=RING_DEPTH,
                                 donate=donate) as ring:
            def committed():
                ring.commit_next()
                if not capture:
                    return
                h = w.capture_async(doc)
                if donate:
                    bundles.append(h.result(300))
                else:
                    handles.append(h)
            for b in batches:
                ring.feed(b)
                while ring._n_fed >= RING_DEPTH:
                    committed()
            while ring._n_fed:
                committed()
            stats = ring.stats
        doc._materialize(with_pos=False)
        scal = doc._scalars()
        stream_s = time.perf_counter() - t0
        bundles += [h.result(300) for h in handles]
        drain_s = time.perf_counter() - t0
        wstats = dict(w.stats)
    return doc, {"s": stream_s, "drain_s": drain_s, "n_vis": int(scal[0]),
                 "stats": stats, "writer": wstats}, bundles


def ckpt_ring(torch, M, card: str, device=None, base_n: int = BASE_LEN,
              n_batches: int = RING_BATCHES, n_actors: int = RING_ACTORS,
              ops: int = OPS_PER_CHANGE) -> dict:
    """(c) the cfg5f stream with a capture after each committed batch,
    with and without in-place commits, and once without captures; every
    bundle restores to a doc whose text is the reference's after some k
    batches (a consistent prefix). Raises on any failure."""
    run = ops // 2
    batches = ring_batches(M, base_n, n_batches, n_actors, ops)
    total_ops = sum(b.n_ops for b in batches)
    n_vis = base_n + n_batches * n_actors * run
    want = {}

    def want_sha(k):
        if k not in want:
            want[k] = sha(expected_stream_text(base_n, n_actors, run, k))
        return want[k]
    t_phase = time.perf_counter()
    out = {}
    for label, donate, capture in (("plain", True, False),
                                   ("donate", True, True),
                                   ("no_donate", False, True)):
        doc, rec, bundles = ring_captures(torch, M, batches, base_n,
                                          device, donate, capture)
        if rec["n_vis"] != n_vis or sha(doc.text()) != want_sha(n_batches):
            raise AssertionError(f"ckpt-c {label}: the stream's text "
                                 "differs from the reference")
        del doc
        ks = []
        for data in bundles:
            d = M.ckpt.restore_engine(data, device)
            k, rem = divmod(d.n_elems - base_n, n_actors * run)
            if rem or not 0 <= k <= n_batches or sha(d.text()) != \
                    want_sha(k):
                raise AssertionError(f"ckpt-c {label}: a bundle is not a "
                                     "consistent prefix of the stream")
            ks.append(k)
            del d
        w = rec["writer"]
        if capture and len(bundles) != n_batches + (not donate):
            raise AssertionError(f"ckpt-c {label}: {len(bundles)} bundles")
        if donate and capture and (w["sync_fallbacks"] != n_batches
                                   or w["async_captures"]):
            raise AssertionError(f"ckpt-c {label}: the deferred grab of "
                                 f"an in-place doc did not refuse: {w}")
        if donate and capture and ks != list(range(1, n_batches + 1)):
            raise AssertionError(f"ckpt-c {label}: boundary captures {ks}")
        out[label] = {"ops_per_s": total_ops / rec["s"], "stream_s": rec["s"],
                      "drain_s": rec["drain_s"], "prefixes": ks,
                      "writer": w, "stats": rec["stats"]}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"ckpt-c ring under captures ({card}): "
        + "; ".join(f"{k}: {v['ops_per_s']:.0f} ops/s (stream "
                    f"{v['stream_s']:.4f} s, drained {v['drain_s']:.4f} s, "
                    f"prefixes {v['prefixes']}, writer {v['writer']})"
                    for k, v in out.items() if k != "wall_s")
        + f"; wall {out['wall_s']:.2f} s")
    return out


def ckpt_phase(torch, M, card: str, device=None, base_n: int = BASE_LEN,
               tail_actors: int = CKPT_TAIL_ACTORS,
               tail_ops: int = CKPT_TAIL_OPS, n_base: int = API_TEXT,
               n_changes: int = API_CHANGES, ring_base: int = BASE_LEN,
               ring_batches_n: int = RING_BATCHES,
               ring_actors: int = RING_ACTORS, ring_ops: int = OPS_PER_CHANGE,
               out_dir: str = None) -> dict:
    """The checkpoint tier on `device`: (a) the engine cold start, (b) the
    API's checkpoint forms (and the CPU backend's run of them, which must
    give the same bytes), (c) the ring under captures, (d) obs (inside
    (a); here the Prometheus pages of the device-truth and lineage
    families). The kernel counts are set to 0 before the phase and read
    after it. Raises on any failed check."""
    cuda = torch.device(device or "cuda").type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    M.S.reset_launches()
    a = ckpt_engine(torch, M, card, device, base_n, tail_actors, tail_ops,
                    out_dir)
    M.lineage.enable(rate=1, capacity=4096)
    try:
        b, got = ckpt_api(torch, M, card, device, n_base, n_changes)
        page = M.prom.expose(M.dt.families() + M.lineage.families())
        prom = M.prom.validate_prom(page)
        for fam in ("amtpu_device_kernel_calls_total",
                    "amtpu_device_footprint_bytes",
                    "amtpu_lineage_span_seconds", "amtpu_lineage_chains"):
            if fam not in page:
                raise AssertionError(f"ckpt-d: {fam} missing from the page")
    finally:
        M.lineage.disable()
        M.lineage.clear()
    c = ckpt_ring(torch, M, card, device, ring_base, ring_batches_n,
                  ring_actors, ring_ops)
    if cuda:
        torch.cuda.synchronize()
    launches = dict(M.S.launches)
    shapes = {k: dict(v) for k, v in M.S.launch_shapes.items()}
    if cuda:
        _b_cpu, want = ckpt_api(torch, M, "cpu backend", "cpu", n_base,
                                n_changes, timed_reps=False)
        if got != want:
            raise AssertionError("ckpt-b: the card's checkpoint, delta and "
                                 "save bytes differ from the CPU backend's")
        if not launches["multi_scan"] or not launches["fused_segment_scans"]:
            raise AssertionError(f"ckpt: a kernel missed the checkpoint "
                                 f"path: {launches}")
    out = {"a": a, "b": b, "c": c, "prom": prom, "launches": launches,
           "shapes": shapes}
    log(f"checkpoint phase launches: {launches}; prom page {prom}; card "
        "bytes equal to the CPU backend's")
    log("ckpt record: " + json.dumps(dict(out, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in shapes.items()}), default=str))
    return out


def _profiled(torch, cuda: bool, fn):
    """fn() under torch.profiler: (wall s, device kernel µs, device
    operations, the device events, the profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return (wall, sum(e.self_device_time_total for e in events),
            sum(e.count for e in events), events, prof)


def profile_api(torch, M, out_dir: str, device=None):
    """api-a: one trellis merge (after a warm-up merge) under
    torch.profiler — wall time, device kernel time, busy share — and
    under cProfile. api-b: the creating change of the 100,000-char Text,
    one write-behind insert and the get_patch read that flushes 60 pending
    inserts, each under torch.profiler, and the flush under cProfile."""
    am = M.am
    backend = am.backend.backend_for(device)
    base, changes, n_ops = trellis_changes(am, am.backend.facade.Backend,
                                           API_ACTORS, API_CARDS, backend)
    saved = am.save(base)
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    os.makedirs(out_dir, exist_ok=True)

    def report(label, prof_out, trace):
        wall, dev_us, n_dev, _events, prof = prof_out
        log(f"profile {label}: wall {wall * 1e3:.3f} ms, device kernel time "
            f"{dev_us / 1e3:.3f} ms, device busy share "
            f"{dev_us / 1e3 / (wall * 1e3):.4f}, {n_dev} device operations")
        prof.export_chrome_trace(os.path.join(out_dir, trace))

    def merge():
        fresh = am.load(saved, {"actorId": "merger", "backend": backend})
        am.apply_changes(fresh, changes)
        sync()
    merge()
    report(f"api-a merge ({n_ops} ops, load + apply_changes)",
           _profiled(torch, cuda, merge), "torch_api_merge.json")
    log("host profile of one api-a merge (load + apply_changes):")
    host_profile(merge)

    box = {}

    def create():
        box["doc"] = am.change(
            am.init({"actorId": "user", "backend": backend}),
            lambda d: d.__setitem__("t", am.Text("x" * API_TEXT)))
        sync()
    report(f"api-b creating change ({API_TEXT} chars)",
           _profiled(torch, cuda, create), "torch_api_create.json")

    def insert(i):
        box["doc"] = am.change(box["doc"], lambda d: d["t"].insert_at(
            5000 + 11 * i, *"helloworld"))
        sync()
    for i in range(API_CHANGES - 1):
        insert(i)
    report("api-b one write-behind insert",
           _profiled(torch, cuda, lambda: insert(API_CHANGES - 1)),
           "torch_api_insert.json")
    state = am.frontend.get_backend_state(box["doc"])

    def flush():
        am.backend.default.get_patch(state)
        sync()
    report(f"api-b get_patch read flushing "
           f"{len(state._core.pending)} pending inserts",
           _profiled(torch, cuda, flush), "torch_api_flush.json")
    for i in range(API_CHANGES):
        insert(i)
    state = am.frontend.get_backend_state(box["doc"])
    log("host profile of the api-b flush read:")
    host_profile(flush)


def host_profile(fn, top: int = 16):
    """cProfile of one fn() call: the host functions that took the most
    time of their own, printed as seconds of own time | cumulative |
    calls | function."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: kv[1][2], reverse=True)
    log("own s | cumulative s | calls | function")
    for (path, line, name), (_cc, nc, tt, ct, _callers) in rows[:top]:
        log(f"{tt:.4f} | {ct:.4f} | {nc} | "
            f"{os.path.basename(path)}:{line} {name}")


def profiled_apply(torch, M, device, n_text: int, n_map: int):
    """One 8a apply of `n_text` text and `n_map` map docs (after the seed
    round and one warm-up rep) under torch.profiler. Returns (wall s,
    device time µs, device operations, the device events, the profiler,
    apply(chunk), the next rep's rounds)."""
    text_ids = [f"fz-t{i:05d}" for i in range(n_text)]
    map_ids = [f"fz-m{i:05d}" for i in range(n_map)]
    seed, reps = fused_stream(text_ids, map_ids, FUSED_KEYS, FUSED_ROUNDS,
                              FUSED_OPS, 3)
    docs, _ = run_stacked(torch, M, device, text_ids, map_ids, 1024, 256,
                          seed, reps[:2])
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def apply(chunk):
        if not M.stacked.apply_stacked([(docs[k], v)
                                        for k, v in chunk.items()]):
            raise AssertionError("profiled apply left the stacked path")
        sync()
    sync()
    return _profiled(torch, cuda, lambda: apply(reps[2][0])) + (apply,
                                                                reps[2])


def profile_multi_doc(torch, M, out_dir: str, device=None):
    """One 8a apply (after the seed round and one warm-up rep) under
    torch.profiler — its wall time, the summed device time of its kernels
    and the device's busy share — then the device operations of the same
    apply over a quarter of the population (whether they grow with the
    doc count), one 8a apply under cProfile (the host functions that took
    the most time), and one 8c build + planned texts() under cProfile."""
    wall, dev_us, n_ops, events, prof, apply, rounds = profiled_apply(
        torch, M, device, FUSED_TEXT_DOCS, FUSED_MAP_DOCS)
    log(f"profile 8a apply: wall {wall * 1e3:.3f} ms, device kernel time "
        f"{dev_us / 1e3:.3f} ms, device busy share "
        f"{dev_us / 1e3 / (wall * 1e3):.4f}, {n_ops} device operations")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    log("self device ms | calls | kernel")
    for e in events[:10]:
        log(f"{e.self_device_time_total / 1e3:14.4f} | {e.count:5d} | "
            f"{e.key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "torch_stacked_apply.json")
    prof.export_chrome_trace(path)
    log(f"trace: {path}")
    q_text, q_map = FUSED_TEXT_DOCS // 4, FUSED_MAP_DOCS // 4
    q = profiled_apply(torch, M, device, q_text, q_map)
    log(f"profile 8a apply over {q_text} text + {q_map} map docs: "
        f"{q[2]} device operations (against {n_ops} over "
        f"{FUSED_TEXT_DOCS} + {FUSED_MAP_DOCS}), wall {q[0] * 1e3:.3f} "
        f"ms, device kernel time {q[1] / 1e3:.3f} ms")
    log("host profile of one 8a apply:")
    host_profile(lambda: apply(rounds[1]))
    ids = [f"d{d}" for d in range(DOCSET_DOCS)]
    batches = {f"d{d}": docset_batch(M.TB, M.C, f"d{d}", d, DOCSET_ACTORS,
                                     DOCSET_CHARS)
               for d in range(DOCSET_DOCS)}

    def build():
        ds = M.DeviceTextDocSet(ids, capacity=DOCSET_ACTORS * DOCSET_CHARS
                                + 64, device=device)
        ds.apply_batches(batches)
        ds.texts()
    build()
    log("host profile of one 8c build + planned texts():")
    host_profile(build)


def port_modules():
    """The port's modules the phases drive (ImportError when the package
    is not beside this script)."""
    from types import SimpleNamespace

    import automerge_tpu_torch as am
    from automerge_tpu_torch import _common, _uuid, checkpoint, native, obs
    from automerge_tpu_torch.backend import device as device_backend
    from automerge_tpu_torch.engine import (DeviceMapDoc, DeviceTextDocSet,
                                            MapChangeBatch,
                                            PipelinedIngestor, accounting,
                                            runs, stacked)
    from automerge_tpu_torch.engine.columnar import TextChangeBatch
    from automerge_tpu_torch.engine.text_doc import DeviceTextDoc
    from automerge_tpu_torch.obs import device_truth, export, lineage, prom
    from automerge_tpu_torch.ops import scan_kernels
    from automerge_tpu_torch.ops.ingest import bucket
    return SimpleNamespace(
        C=_common, native=native, obs=obs, ckpt=checkpoint, uuid=_uuid,
        dt=device_truth, export=export, lineage=lineage, prom=prom,
        DeviceMapDoc=DeviceMapDoc,
        MapChangeBatch=MapChangeBatch, PipelinedIngestor=PipelinedIngestor,
        accounting=accounting, runs=runs, TB=TextChangeBatch,
        DeviceTextDoc=DeviceTextDoc, DeviceTextDocSet=DeviceTextDocSet,
        stacked=stacked, S=scan_kernels, bucket=bucket, am=am,
        device_backend=device_backend)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile the headline commit of both "
                         "materialization paths and the multi-document "
                         "tier; traces go to DIR")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        M = port_modules()
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}",
              file=sys.stderr)
        return 2
    C, TB, S = M.C, M.TB, M.S
    DeviceTextDoc, accounting = M.DeviceTextDoc, M.accounting
    if "jax" in sys.modules or any(m.startswith("automerge_tpu.")
                                   or m == "automerge_tpu"
                                   for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")

    # 1. device
    card = nvidia_smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"card: {card}")

    # 2. build: the CUDA kernels (nvcc) and the host codec (g++), started
    # together
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        native_build = ex.submit(timed, M.native.load)
        built = S.build()
        native_s = native_build.result()
    log(f"build: {built:.2f} s compiling {S.SOURCE.name}, {native_s:.2f} s "
        f"building and loading {M.native.library_path().name} from "
        f"{M.native.SOURCE.name} ({time.perf_counter() - t0:.2f} s with "
        "the check)")
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
    del doc, cpu_doc

    # 6a. the streaming ring: bench.py --pipeline's stream at full width
    ring = ring_phase(torch, M, card)
    if any("diverged" in m for m in heals.records):
        raise AssertionError(f"segment mirror healed: {heals.records}")

    # 6b. a 1,000,000-key map document: fast-path and slow-path rounds
    map_phase(torch, M, card)

    # 8. the multi-document tier (it runs before phase 7, which times the
    # kernels at every shape the paths launched): 8a the stacked executor
    # at cfg17, 8b the largest stack one card takes under the cell gate
    # (cfg12's lane), 8c the DocSet at cfg3
    fz_text = [f"fz-t{i:05d}" for i in range(FUSED_TEXT_DOCS)]
    fz_map = [f"fz-m{i:05d}" for i in range(FUSED_MAP_DOCS)]
    st_a = stacked_phase(
        torch, M, card, "8a stacked cfg17", text_ids=fz_text,
        map_ids=fz_map, text_cap=1024, map_cap=256,
        stream=fused_stream(fz_text, fz_map, FUSED_KEYS, FUSED_ROUNDS,
                            FUSED_OPS, 1 + STACK_REPS))
    sh_text = [f"tdoc-{i:05d}" for i in range(SHARD_TEXT_DOCS)]
    sh_map = [f"mdoc-{i:05d}" for i in range(SHARD_MAP_DOCS)]
    st_b = stacked_phase(
        torch, M, card, "8b stacked cfg12 lane", text_ids=sh_text,
        map_ids=sh_map, text_cap=SHARD_CAP, map_cap=SHARD_CAP,
        stream=shard_stream(sh_text, sh_map, 64, SHARD_ROUNDS,
                            1 + STACK_REPS))
    if st_b["cells"] > 1 << 23:
        raise AssertionError(f"8b stacks {st_b['cells']} cells")
    dset = docset_phase(torch, M, card)
    stacked_launches = {k: st_a["launches"][k] + st_b["launches"][k]
                        for k in S.launches}

    # 9. the public API on the card (before phase 7 too): api-a cfg4's
    # trellis merge at 1,000 actors, api-b cfg7's interactive latency on a
    # 100,000-char text, api-c one graduation
    api = api_phase(torch, M, card)
    stacked_shapes = {k: {sh: st_a["shapes"][k].get(sh, 0)
                          + st_b["shapes"][k].get(sh, 0)
                          for sh in set(st_a["shapes"][k])
                          | set(st_b["shapes"][k])} for k in S.launches}

    # 12. the checkpoint tier (before phase 7 too): the engine cold start
    # at bench.py measure_restore's sizes under obs.tracing(), the API's
    # checkpoint forms on api-b's document, the cfg5f ring under captures
    ckpt = ckpt_phase(torch, M, card,
                      out_dir=os.path.join(here, "chiprun_out"))

    # 7. kernel times at every shape the driven paths launched with, then
    # one kernel per call (a profiler session slows later host launches)
    shapes_by_path = {"main": main_shapes, "self_contained": sc_shapes,
                      "residual": res_shapes, "pipeline": ring["shapes"],
                      "stacked": stacked_shapes, "docset": dset["shapes"],
                      "api": api["shapes"], "checkpoint": ckpt["shapes"]}
    log(f"launches by shape on the driven paths: {shapes_by_path}")
    shapes = {k: set().union(*(p[k] for p in shapes_by_path.values()))
              for k in S.launches}
    n_elems_of = {1_048_576: BASE_LEN, N_MERGE: n_expect}
    times = time_kernels(
        torch, S, shapes["multi_scan"], shapes["fused_segment_scans"],
        lambda sh: (n_elems_of.get(sh[0], sh[0] - sh[0] // 16)
                    if len(sh) == 1 else
                    [min(sh[1] - 1, DOCSET_ACTORS * DOCSET_CHARS)] * sh[0]))
    per_call = check_kernels_per_call(torch, S)

    # 10. optional profiles: the headline commit, the multi-document
    # tier, one api-a merge
    if args.profile:
        for planned in (True, False):
            profile_commit(torch, DeviceTextDoc, TB, C, planned,
                           args.profile)
        profile_multi_doc(torch, M, args.profile)
        profile_api(torch, M, args.profile)

    # 11. kernel records: `launches` is the count on the path the kernel
    # serves (multi_scan: the planned main path; fused_segment_scans: the
    # self-contained one); `launches_by_path` has each driven path's count
    by_path = {"main": main_launches, "self_contained": sc_launches,
               "residual": res_launches, "pipeline": ring["launches"],
               "stacked": stacked_launches, "docset": dset["launches"],
               "api": api["launches"], "checkpoint": ckpt["launches"]}
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
