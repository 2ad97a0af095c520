#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (automerge_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--profile DIR] [--blocking-sync]
    python3 chip_smoke.py --lane-probe [--blocking-sync]
    python3 chip_smoke.py --workloads
    python3 chip_smoke.py --soak [--profile DIR]

It builds the CUDA kernels from csrc/ and holds each kernel bit-exact
against its plain PyTorch version: at the main path's shapes, at ragged
and tile-edge sizes, on unaligned views, twice in a row on one shape (a
reused scratch) and 50 times at each merge shape. It then drives the
port's DeviceTextDoc through the headline text merge at full width (a
1,000,000-char document taking a 10,000-actor x 1,000-op concurrent
batch), the self-contained materialization, a residual round and its
pull, bench.py's `--pipeline` stream, a 1,000,000-key map
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
a capture after each commit, every bundle a consistent prefix), and the
sync tier (phase 13: run_all.py config9_sync_fanout's 20 peers x 50
changes on cfg7's 100,000-char text, a reconnect and a late full-history
join; a 20-peer join storm in one hub.batched() window served from one
snapshot; two replicas under wan_pair(cross_region) chaos; each against
the CPU backend's run of the same stream), and the sharded serving tier
(phase 14: bench.py measure_sharded's cfg12 populations on 8 lanes,
streams of the card, with the lane workers, sequentially and on one lane;
the router's park/drain and migrations; cfg18 through the pager; each
against a CPU run), and the mesh path (phase 15: the sharded segment
scans' kernel pair over 2, 4 and 8 virtual shards of the card, bit-exact
against its plain version and the unsharded kernel; the headline
document materialized with its columns elem-sharded over 8 shards; the
cfg3 DocSet on a (2, 4) mesh of virtual shards and on the machine's
cards; the multi-shard dry run and the commit-path exchange audit), the
service tier (phase 16: run_all.py config11_service's 200 tenant
sessions in rooms of 5; the same service on 4 rooms of cfg7's
100,000-char text, where multi_scan must launch in the timed window;
16a's population on 8 lanes with the pager, sequential and pipelined
ticks; the loopback scrape endpoint with lineage on; 16a and 16b against
a CPU run), and the federation (phase 17: scripts/soak.py
session_federation's 3 regions, 6 rooms, 1,000 write sessions with
partitions and a killed region rejoining empty, byte-identical at the
end with zero residual lag), and the JAX package's remaining workloads
(phase 18: run_all.py cfg5b's residual-heavy and cfg5c's two-round
merges of 10,000 actors into a 1,000,000-char document, cfg6's 200
conflicting writers, cfg2's shared counter, cfg10's save/load and cfg7b's
nested edits under a 100,000-key root, each against a CPU run), the soak
campaign (phase 19: scripts/soak.py's general, conflict, lossy, table,
chaos, checkpoint, service, sharded and residency sessions at seeds 0-2
and a 1,000-client service session, each ending in the same state as
the same seed on the CPU) and the cold text-planning population (phase
20: bench.py cfg12t/cfg19's 512 text documents through the cross-doc
planner, the batch index and the learned index, against a CPU run); times
each kernel at every shape those paths launched
it with (device time over CUDA-graph replays, inputs rotated through
copies so each call reads them from HBM; one eager call at the merge
shapes is timed before the paths); and checks that each wrapper call runs
one kernel and no other device operation, in each form. Every phase
raises on failure.
With --profile, it then runs the headline commit (commit_prepared +
_materialize + _scalars) of each materialization path and one stacked
apply and one api-a merge once more under torch.profiler, prints the
device's busy share and the kernels that took the most device time,
writes the Chrome traces to DIR, and prints the host profile (cProfile)
of one stacked apply, one DocSet build and one api-a merge.
With --lane-probe, it runs only `lane_probe` (shard-a's map population
served alternately with the lane workers and sequentially, each lane
ingest timed in wall and thread CPU time) and prints its record last.
With --workloads, it builds the kernels and runs only phase 18, then
one 18a commit under cProfile and one under torch.profiler, and prints
the phase's record last.
With --soak, it builds the kernels and runs only phases 19-20 (with
--profile, one more planning stream under torch.profiler), and prints
their record last.
With --blocking-sync, host waits on the card block instead of spinning.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BASE_LEN = 1_000_000
N_ACTORS = 10_000
OPS_PER_CHANGE = 1_000
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12          # non-tensor fp32 rate, taken for int32 adds
REPS = 25
REPEATS = 50                   # bit-exact launches at each merge shape
MAX_COPIES = 64                # input copies a kernel timing rotates through
HOST_CALLS = 200               # back-to-back calls a host-time reading takes
HOST_READS = 5                 # readings a host time is the median of
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
SYNC_PEERS = 20                # sync-a: run_all.py config9_sync_fanout's 20
SYNC_CHANGES = 50              # peers x 50 changes, on cfg7's 100,000 chars
SYNC_STORM = 20                # sync-b: joiners in one hub.batched() window
SYNC_STORM_MIN = 32            # sync-b: the storm hub's snapshot_min_changes
SYNC_CHAOS_EDITS = 50          # sync-c: concurrent edits on each side
MESH_LANES = 8                 # shard-a: bench.py measure_sharded's 8 lanes
MESH_WARMUP = 1                # (streams of the one card); bench.py's 2
MESH_REPS = 3                  # warm-up and 5 timed reps, cut to 1 and 3 to
#                                keep the whole script inside its time limit
ONE_LANE_WARMUP = 0            # the one-lane per-object leg's reps, cut
ONE_LANE_REPS = 1              # from bench.py's 2 + 5 (13-26 s a map rep)
MESH_CPU_DOCS = 64             # docs of each lane the CPU mesh replays
HOT_OPS = 512                  # shard-b: the hot doc's ops per round, and
HOT_ROUNDS = 40                # the most rounds it may take to move
RES_DOCS = 140                 # shard-c: bench.py measure_residency's
RES_BUDGET_DOCS = 8            # 140 text docs, budget of 8 docs' bytes,
RES_ROUNDS = 32                # 32 rounds a rep, 3 timed reps, capacity
RES_REPS = 3                   # 1,024, revisit lag 10, cold_after 6
RES_CAP = 1024
RES_LAG = 10
RES_COLD_AFTER = 6
MESH_SHARDS = (2, 4, 8)        # 15a: virtual shards of the card the kernel
MESH_RAGGED = 8 * 100_003      # pair runs over; a shard of no whole tile
MESH_DOCSET = (2, 4)           # 15c: the cfg3 DocSet's (doc, elem) mesh
DMESH_REPS = 3                 # 15c: timed fresh runs after one warm-up
#: segment-scan row lengths on each form boundary (warp <= 1,024 < block
#: <= 8,192 < look-back) and a row of several tiles
FORM_EDGES = (96, 1023, 1024, 1025, 8191, 8192, 8193, 3 * 8192 + 5)
#: multi_scan row lengths on each form edge (warp <= 1,024 < block <=
#: 8,192 < look-back) and inside the warp form's first round, and the row
#: counts around the warp form's 8 rows a block
MS_EDGES = (1, 31, 32, 33, 1023, 1024, 1025, 8191, 8192, 8193)
MS_EDGE_ROWS = (1, 7, 8, 9)
#: 15a's row cases, (D, C) over 4 elem shards: the cfg3 DocSet's rows (a
#: shard 192 slots: warp form), a shard row past 1,024 (block form) and
#: one past 8,192 (look-back form)
MESH_ROW_CASES = ((DOCSET_DOCS, 768), (64, 4 * 1025), (16, 4 * 8193))
SVC_SESSIONS = 200             # 16a: run_all.py config11_service's 200
SVC_ROOM = 5                   # tenant sessions in rooms of 5, 10 rounds,
SVC_ROUNDS = 10                # TenantBudget(ops_per_tick=256,
SVC_OPS_PER_TICK = 256         # inbox_cap=64)
SVC_INBOX = 64
SVC_TEXT_ROOMS = 4             # 16b: 4 rooms of 5 on cfg7's 100,000 chars,
SVC_TEXT_EDIT = "0123456789"   # each edit sync-a's 10 chars at index 0
SVC_LANES = 8                  # 16c: 16a on 8 lanes (streams of the card),
SVC_RES_ROOMS = 8              # the pager's budget 8 docs' bytes
FED_ROOMS = 6                  # 17: scripts/soak.py session_federation's
FED_SESSIONS = 1_000           # 3 regions, 6 rooms, 1,000 write sessions
FED_TICKS = 80                 # over 80 ticks, seed 0
ADV_ACTORS = 10_000            # 18a-b: run_all.py cfg5b and cfg5c, 10,000
ADV_BASE = 1_000_000           # actors on a 1,000,000-char base
ADV_REPS = 5                   # timed runs of each part, after one warm-up
CONFLICT_ACTORS = 200          # 18c: run_all.py config6_conflict_heavy's
CONFLICT_TARGETS = 500         # 200 actors x 500 shared targets
COUNTER_ACTORS = 100           # 18d: run_all.py config2_map_counter's 100
COUNTER_KEYS = 100             # actors x 100 keys + one shared counter
SAVE_CHANGES = 40              # 18e: run_all.py config10_save_load's 40
SAVE_RUN = 250                 # changes of 250 chars
NESTED_ROOT = 100_000          # 18f: run_all.py config7b's 100,000 root
NESTED_CHANGES = 20            # keys and 20 nested edits


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
    replays, over the calls. The graph is captured on the stream that ran
    the warm-up calls, so the segment scans' per-stream scratch is sized
    before the capture."""
    calls = len(fns) * -(-calls // len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns[:2]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
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


def device_ops_per_call(torch, fn) -> list:
    """The names of the device operations (kernels, memsets, copies) one
    call of fn() runs, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


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

    check_ms_forms(torch, S, rng, dev)
    check_forms(torch, S, rng, dev)

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


def check_ms_forms(torch, S, rng, dev):
    """multi_scan's three forms at their edges (a warp a row up to 1,024
    columns, a block a row up to 8,192, the look-back beyond): MS_EDGES
    columns x MS_EDGE_ROWS rows, on aligned views and on views 4 bytes off
    16 (the scalar path), with small values and with values near the int32
    limits whose sums wrap; bit-exact against `multi_scan_plain`, and the
    host's form the one the library expects."""
    lib = S.load()
    seen = []
    for n in MS_EDGES:
        form = S.ms_geometry(1, n).form
        if lib.amt_ms_form(n) != form:
            raise AssertionError(f"multi_scan form of a {n}-column row: "
                                 f"host {form}, library "
                                 f"{lib.amt_ms_form(n)}")
        for K in MS_EDGE_ROWS:
            for lead in (0, 1):
                for lo, hi in ((-50, 50), (2**30, 2**31 - 1)):
                    buf = rng.integers(lo, hi, K * n + lead, dtype=np.int32)
                    x = torch.from_numpy(buf).to(dev)[lead:].view(K, n)
                    if hi > 2**30:
                        x[1::2] = -x[1::2]         # wrap both ways
                    if (x.data_ptr() % 16 != 0) != bool(lead):
                        raise AssertionError("the unaligned case is aligned")
                    if not torch.equal(S.multi_scan(x),
                                       S.multi_scan_plain(x)):
                        raise AssertionError(
                            f"multi_scan differs at ({K}, {n}), offset "
                            f"{4 * lead} bytes, values [{lo}, {hi})")
        seen.append(f"{n}: {S.FORMS[form]}")
    log(f"multi_scan forms bit-exact vs plain ({MS_EDGE_ROWS} rows; offsets "
        "0 and 4 bytes; small and int32-wrapping values): "
        f"{', '.join(seen)}")


def check_forms(torch, S, rng, dev):
    """The segment scans' three forms at their edges (a warp a row up to
    1,024 slots, a block a row up to 8,192, the look-back beyond), as one
    column and as 7 rows, on aligned views and on views one byte off 16
    bytes (the scalar path; rows off a multiple of 16 take it too):
    `fs_totals`, the carry-in scan (3 earlier shards of random totals) and
    `fused_segment_scans` bit-exact against their plain versions, and the
    host's form the one the library expects."""
    lib = S.load()
    seen = []
    for n in FORM_EDGES:
        form = S.fs_geometry("fs_scan", 1, n).form
        if lib.amt_fs_form(n) != form:
            raise AssertionError(f"form of a {n}-slot row: host "
                                 f"{form}, library {lib.amt_fs_form(n)}")
        for D, lead in ((None, 0), (None, 1), (7, 0), (7, 1)):
            m = (D or 1) * n
            chain = torch.from_numpy(rng.random(m + lead) < 0.8).to(dev)
            has = torch.from_numpy(rng.random(m + lead) < 0.9).to(dev)
            chain, has = chain[lead:], has[lead:]
            lead_dims = (4,) if D is None else (4, D)
            carry = torch.from_numpy(np.stack(
                [rng.integers(0, n, lead_dims), rng.integers(0, 3 * n,
                                                             lead_dims),
                 rng.integers(0, n, lead_dims)], -1).astype(np.int32)).to(dev)
            if D is None:
                ne = n - n // 9
            else:
                chain, has = chain.view(D, n), has.view(D, n)
                cnt = rng.integers(0, n + 1, D).astype(np.int32)
                cnt[0], cnt[-1] = 0, n
                ne = torch.from_numpy(cnt).to(dev)
            base = 3 * n
            pairs = (
                ((S.fs_totals(chain, has, ne, base),),
                 (S.fs_totals_plain(chain, has, ne, base),)),
                (S.fused_segment_scans_carry(chain, has, ne, base, carry, 3),
                 S.fused_segment_scans_carry_plain(chain, has, ne, base,
                                                   carry, 3)),
                (S.fused_segment_scans(chain, has, ne, base),
                 S.fused_segment_scans_plain(chain, has, ne, base)))
            torch.cuda.synchronize()
            for k, (got, want) in enumerate(pairs):
                if not _fs_equal(torch, got, want):
                    raise AssertionError(
                        f"{('fs_totals', 'carry-in fs_scan', 'fs_scan')[k]}"
                        f" differs at rows {D} x {n} slots, offset {lead}")
        seen.append(f"{n}: {S.FORMS[form]}")
    log("segment-scan forms bit-exact vs plain (fs_totals, carry-in and "
        f"plain fs_scan; a column and 7 rows; offsets 0 and 1): "
        f"{', '.join(seen)}")


def check_kernels_per_call(torch, S):
    """Each wrapper call runs one device kernel and nothing else at all
    (no memset, no fill), in each form: `multi_scan` at (6, 256), (6,
    8,192) and the merge shape, the three segment-scan wrappers at a warp,
    a block and a look-back shape. Runs after phases 1-15, since a
    profiler session left behind slows the host's later launches, and
    before phases 16-17 and phase 7's CUDA graphs: after either, a
    profiler session has shown no device activity at all for an
    `fs_totals` call that ran. Returns the kernels per call."""
    dev = torch.device("cuda")
    ops, kernels = {}, {}
    for shape in ((6, 256), (6, 8192), (6, N_MERGE)):
        x = torch.zeros(shape, dtype=torch.int32, device=dev)
        form = S.FORMS[S.ms_geometry(*shape).form]
        got = device_ops_per_call(torch, lambda: S.multi_scan(x))
        ops[f"multi_scan {form}"] = got
        kernels.setdefault("multi_scan", []).extend(got)
        if len(got) != 1 or "ms_scan" not in got[0]:
            raise AssertionError(f"multi_scan at {shape} ({form} form) ran "
                                 f"{got}, not one kernel alone")
        del x
    for shape in ((N_MERGE,), (1, 5000), (DOCSET_DOCS // 2, 192)):
        c = torch.zeros(shape, dtype=torch.bool, device=dev)
        ne = (6_000_000 if len(shape) == 1 else torch.full(
            shape[:1], shape[1] - 1, dtype=torch.int32, device=dev))
        carry = torch.zeros((2,) + shape[:-1] + (3,), dtype=torch.int32,
                            device=dev)
        form = S.FORMS[S.fs_geometry("fs_scan", *(
            shape if len(shape) == 2 else (1,) + shape)).form]
        for name, fn in (
                ("fused_segment_scans",
                 lambda: S.fused_segment_scans(c, c, ne)),
                ("fs_totals", lambda: S.fs_totals(c, c, ne)),
                ("sharded_fused_scans",
                 lambda: S.fused_segment_scans_carry(c, c, ne, 0, carry,
                                                     1))):
            got = device_ops_per_call(torch, fn)
            ops[f"{name} {form}"] = got
            kernels.setdefault(name, []).extend(got)
            if len(got) != 1 or not any(k in got[0] for k in ("fs_scan",
                                                              "fs_totals")):
                raise AssertionError(f"{name} at {shape} ({form} form) ran "
                                     f"{got}, not one kernel alone")
    log(f"device operations per wrapper call: {ops}")
    return {k: len(v) // 3 for k, v in kernels.items()}


def _ms_bound(K, N):
    # reads and writes 4 bytes per element; one add per element
    return bound(2 * K * N * 4, K * N)


def _fs_bound(shape):
    # reads chain + has (1 B each) and one n_elems per row, writes three
    # int32 columns; `shape` is (C,), (D, C) or a column length C (as
    # scripts/sweep_scan_tiles.py passes it)
    if isinstance(shape, int):
        shape = (shape,)
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


def fs_form(S, shape) -> str:
    """The form the segment scans take at `shape` ((C,) or (D, C))."""
    D, C = shape if len(shape) == 2 else (1, shape[0])
    return S.FORMS[S.fs_geometry("fs_scan", D, C).form]


def host_us(torch, fn, calls: int = HOST_CALLS,
            reads: int = HOST_READS) -> float:
    """Host microseconds of one fn() call: the median of `reads` readings,
    each the mean over `calls` calls issued back to back (the card drains
    after the clock stops)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reads):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(out))


def wrapper_host_us(torch, S) -> dict:
    """Host microseconds per call of `multi_scan` at the per-object
    rounds' (6, 256), phase 20's (3072, 256) and the merge shape, and of
    the three segment-scan wrappers at the mesh path's per-shard shapes
    (15b's 1,048,576-slot shard with an int count, 15c's (500, 192) and
    15d's (2, 96) with per-row counts) and at the merge column, each as
    the mesh path calls it (the carry-in scan as the last of 8 shards).
    Only the wrappers' public signatures are used, so another checkout's
    package can be timed the same way (`--wrapper-host`)."""
    dev = torch.device("cuda")
    out = {}
    for label, shape in (("per-object round", (6, 256)),
                         ("20 stacked round", (3072, 256)),
                         ("merge channels", (6, N_MERGE))):
        x = torch.zeros(shape, dtype=torch.int32, device=dev)
        out[label] = {"shape": list(shape),
                      "multi_scan": host_us(torch, lambda: S.multi_scan(x))}
        del x
    for label, shape in (("15b shard", (1_048_576,)),
                         ("15c shard", (DOCSET_DOCS // 2, 192)),
                         ("15d shard", (2, 96)), ("merge column", (N_MERGE,))):
        c = torch.zeros(shape, dtype=torch.bool, device=dev)
        ne = (shape[0] - shape[0] // 20 if len(shape) == 1 else torch.full(
            shape[:1], shape[1] - 1, dtype=torch.int32, device=dev))
        carry = torch.zeros((8,) + shape[:-1] + (3,), dtype=torch.int32,
                            device=dev)
        out[label] = {
            "shape": list(shape),
            "fs_totals": host_us(torch, lambda: S.fs_totals(c, c, ne, 0)),
            "carry-in fs_scan": host_us(
                torch, lambda: S.fused_segment_scans_carry(c, c, ne, 0,
                                                           carry, 7)),
            "fused_segment_scans": host_us(
                torch, lambda: S.fused_segment_scans(c, c, ne))}
        del c, carry
    log("host us per wrapper call: " + json.dumps(out))
    return out


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
            "shape": [K, N], "form": S.FORMS[S.ms_geometry(K, N).form],
            "copies": len(xs), "max_abs_err": err,
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
            "shape": list(shape), "form": fs_form(S, shape),
            "copies": len(pairs), "max_abs_err": err,
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
            log(f"{name} {r['shape']}"
                + (f" ({r['form']} form)" if "form" in r else "")
                + f": kernel {r['ms']:.4f} ms "
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


def _sync_of(torch, device):
    if torch.device(device or "cuda").type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def part_counts(M, sync):
    """Kernel launch counts of a phase's parts: `counted(part, fn)` sets
    the counts to 0, runs fn between two syncs, records what launched
    under `part` (`by_part`, shapes as "KxN" strings) and adds it to the
    phase's `launches` and `shapes`. Returns (counted, launches, shapes,
    by_part)."""
    launches = {k: 0 for k in M.S.launches}
    shapes = {k: {} for k in M.S.launches}
    by_part = {}

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
    return counted, launches, shapes, by_part


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
    cuda = torch.device(device or "cuda").type == "cuda"
    counted, launches, shapes, by_part = part_counts(M, _sync_of(torch,
                                                                device))
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


# --- the sync tier (run_all.py config9_sync_fanout on cfg7's text) ----------

def _obs_events(M, cat: str, name: str) -> int:
    return sum(1 for r in M.obs.snapshot() if r[2] == cat and r[3] == name)


def _on_device(M, doc, device) -> bool:
    want = "cuda" if device is None else str(device).split(":")[0]
    core = M.am.frontend.get_backend_state(doc)._core
    return all(w.doc.device.type == want
               for w in [core.root] + list(core.objects.values()))


def _pump_pairs(pairs) -> int:
    """Deliver every queued message of each (out_queue, receiver) pair
    until all are empty; returns the messages moved."""
    n = 0
    moved = True
    while moved:
        moved = False
        for q, conn in pairs:
            while q:
                conn.receive_msg(q.pop(0))
                n += 1
                moved = True
    return n


def _connect(am, ds_a, ds_b):
    """A Connection pair between two DocSets; -> the pump pairs."""
    qa, qb = [], []
    ca, cb = am.Connection(ds_a, qa.append), am.Connection(ds_b, qb.append)
    ca.open()
    cb.open()
    return [(qa, cb), (qb, ca)]


def sync_fanout(torch, M, card: str, device, n_base: int, n_peers: int,
                n_changes: int) -> tuple:
    """sync-a: run_all.py config9_sync_fanout at its 20 peers x 50
    changes of 10 chars inserted at index 0, on cfg7's n_base-char Text:
    the author's DocSet fans every change out over hub-backed Connections
    to n_peers DocSets on `device`. Then a peer that missed the 50
    changes reconnects (its catch-up is one frame and no dict prefix: the
    gate's wire fast lane), and a late peer joins with the hub's snapshot
    threshold at 0 (the creation change as dict, the 50-change tail as one
    AMTPUWIRE1 frame). Every replica must hold cfg9's expected text.
    Returns the record and the bytes the CPU backend's run must equal."""
    am = M.am
    be = am.backend.backend_for(device)
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    _pinned_uuids(M)
    try:
        author = am.DocSet(backend=be)
        t = time.perf_counter()
        author.set_doc("doc", am.change(
            am.init({"actorId": "author", "backend": be}),
            lambda d: d.__setitem__("t", am.Text("x" * n_base))))
        sync()
        create_s = time.perf_counter() - t
        peers = [am.DocSet(backend=be) for _ in range(n_peers)]
        offline = am.DocSet(backend=be)
        pairs = []
        for ds in peers + [offline]:
            pairs += _connect(am, author, ds)
        hub = author._sync_hub
        t = time.perf_counter()
        _pump_pairs(pairs)
        sync()
        join_s = time.perf_counter() - t
        off_pairs, pairs = pairs[-2:], pairs[:-2]
        for q, conn in off_pairs:          # the offline peer leaves
            conn.close()
            q.clear()
        # the hub's batched comparisons over the fan-out, the peers' acks
        # included (tests/test_sync_hub.py counts them around set_doc)
        calls = [0]
        pending = hub._matrix.pending

        def counted():
            calls[0] += 1
            return pending()
        hub._matrix.pending = counted
        t = time.perf_counter()
        for k in range(n_changes):
            author.set_doc("doc", am.change(
                author.get_doc("doc"),
                lambda d: d["t"].insert_at(0, *"0123456789")))
            _pump_pairs(pairs)
        sync()
        fan_s = time.perf_counter() - t
        del hub._matrix.pending
        expect = "0123456789" * n_changes + "x" * n_base
        texts = [str(ds.get_doc("doc")["t"]) for ds in peers]
        # each peer's first read of its backend (get_patch) commits the
        # deliveries the write-behind path holds into its engine table
        t = time.perf_counter()
        pending_rounds = 0
        for ds in peers:
            state = am.frontend.get_backend_state(ds.get_doc("doc"))
            pending_rounds += len(state._core.pending)
            patch = be.get_patch(state)
            texts.append("".join(d["value"] for d in patch["diffs"]
                                 if d["action"] == "insert"))
        sync()
        read_s = time.perf_counter() - t
        if any(tx != expect for tx in texts):
            raise AssertionError("sync-a: a peer's text differs from "
                                 "cfg9's expected string")
        if calls[0] != n_changes:
            raise AssertionError(f"sync-a: {calls[0]} pending() calls for "
                                 f"{n_changes} changes")
        if not all(_on_device(M, ds.get_doc("doc"), device) for ds in peers):
            raise AssertionError("sync-a: a peer's document left the "
                                 "device")

        def join(ds, label):
            msgs, qa, qb = [], [], []
            ca = am.Connection(author, lambda m: (qa.append(m),
                                                  msgs.append(m)))
            cb = am.Connection(ds, qb.append)
            ca.open()
            cb.open()
            jp = [(qa, cb), (qb, ca)]
            with M.obs.tracing(1 << 16):
                M.obs.clear()
                t0 = time.perf_counter()
                _pump_pairs(jp)
                got = str(ds.get_doc("doc")["t"])
                sync()
                dt = time.perf_counter() - t0
                fast = _obs_events(M, "gate", "wire_fast")
            if got != expect:
                raise AssertionError(f"sync-a: the {label} peer's text "
                                     "differs")
            data = [m for m in msgs if m.get("changes") or m.get("wire")]
            shape = [(len(m.get("changes") or ()),
                      m["wire"].n_changes if m.get("wire") else 0)
                     for m in data]
            return dt, fast, shape
        recon_s, recon_fast, recon_shape = join(offline, "reconnecting")
        if recon_shape != [(0, n_changes)] or recon_fast != 1:
            raise AssertionError(f"sync-a: the reconnect caught up as "
                                 f"{recon_shape} with {recon_fast} fast-lane"
                                 " deliveries, not one frame of the tail "
                                 "through the fast lane")
        hub.snapshot_min_changes = 0
        late = am.DocSet(backend=be)
        late_s, late_fast, late_shape = join(late, "late")
        if late_shape != [(1, n_changes)]:
            raise AssertionError(f"sync-a: the late join came as "
                                 f"{late_shape}, not the creation change "
                                 "and one frame of the tail")
        del hub.snapshot_min_changes
        saves = [am.save(ds.get_doc("doc")) for ds in
                 (author, peers[0], peers[-1], offline, late)]
        if len(set(saves)) != 1:
            raise AssertionError("sync-a: replicas' save() bytes differ")
    finally:
        M.uuid.reset()
    deliveries = n_changes * n_peers
    out = {"chars": n_base, "peers": n_peers, "changes": n_changes,
           "create_s": create_s, "join_s": join_s, "fanout_s": fan_s,
           "deliveries_per_s": deliveries / fan_s,
           "changes_per_s": n_changes / fan_s, "read_s": read_s,
           "pending_rounds_read": pending_rounds,
           "pending_per_change": calls[0] / n_changes,
           "reconnect_s": recon_s, "reconnect_wire_fast": recon_fast,
           "late_join_s": late_s, "late_join_wire_fast": late_fast,
           "late_join_shape": late_shape}
    log(f"sync-a fan-out ({card}): {n_peers} peers joined a {n_base}-char "
        f"text in {join_s:.3f} s; {n_changes} changes, "
        f"{out['deliveries_per_s']:.1f} deliveries/s "
        f"({fan_s:.3f} s); the peers' first reads {read_s:.3f} s "
        f"({pending_rounds} write-behind rounds committed); "
        f"{out['pending_per_change']:.0f} pending() call per change; "
        f"reconnect {recon_s:.3f} s (one frame, {recon_fast} fast-lane "
        f"delivery); late full-history join {late_s:.3f} s (creation "
        f"change + one frame of {n_changes}, {late_fast} fast-lane); "
        "texts as expected")
    return out, (saves[0], texts[0])


def sync_storm(torch, M, card: str, device, n_base: int, n_changes: int,
               n_peers: int, threshold: int) -> tuple:
    """sync-b: n_peers fresh peers join an author whose document is cfg7's
    n_base-char Text plus n_changes 10-char inserts, all inside one
    hub.batched() window, with the hub's snapshot_min_changes at
    `threshold`: one flush serves them all from ONE capture (obs events
    sync/snapshot_capture = 1, snapshot_serve_cached = n_peers - 1), and
    each peer restores the bundle on `device`. Returns the record and the
    bytes the CPU backend's run must equal."""
    am = M.am
    be = am.backend.backend_for(device)
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    _pinned_uuids(M)
    try:
        author = am.DocSet(backend=be)
        doc = am.change(am.init({"actorId": "author", "backend": be}),
                        lambda d: d.__setitem__("t", am.Text("x" * n_base)))
        for k in range(n_changes):
            doc = am.change(doc, lambda d: d["t"].insert_at(
                0, *"0123456789"))
        author.set_doc("doc", doc)
        history = len(am.frontend.get_backend_state(doc).history())
        anchor = am.Connection(author, lambda m: None)
        anchor.open()                       # the author's shared hub
        hub = author._sync_hub
        hub.snapshot_min_changes = threshold
        peers = [am.DocSet(backend=be) for _ in range(n_peers)]
        sync()
        with M.obs.tracing(1 << 18):
            M.obs.clear()
            t = time.perf_counter()
            pairs = []
            with hub.batched():
                for ds in peers:
                    pairs += _connect(am, author, ds)
                _pump_pairs(pairs)
                t_serve = time.perf_counter()
            _pump_pairs(pairs)
            texts = [str(ds.get_doc("doc")["t"]) for ds in peers]
            sync()
            storm_s = time.perf_counter() - t
            serve_s = time.perf_counter() - t_serve
            # the restored tables read on the device: the planned read,
            # then the self-contained one (mirror dropped), as ckpt-a
            t = time.perf_counter()
            for ds in peers:
                core = am.frontend.get_backend_state(ds.get_doc("doc"))._core
                for w in core.objects.values():
                    ed = w.doc
                    texts.append(ed.text())
                    ed.seg_mirror = None
                    ed._mat = None
                    ed._seg_bound = ed.n_elems + 2
                    texts.append(ed.text())
            sync()
            engine_read_s = time.perf_counter() - t
            captures = _obs_events(M, "sync", "snapshot_capture")
            cached = _obs_events(M, "sync", "snapshot_serve_cached")
        want = str(doc["t"])
        if captures != 1 or cached != n_peers - 1:
            raise AssertionError(f"sync-b: {captures} captures and {cached}"
                                 f" cached serves for {n_peers} joiners")
        if any(tx != want for tx in texts):
            raise AssertionError("sync-b: a joiner's text differs")
        if not all(_on_device(M, ds.get_doc("doc"), device) for ds in peers):
            raise AssertionError("sync-b: a restored document left the "
                                 "device")
        saves = {am.save(ds.get_doc("doc")) for ds in peers}
        if saves != {am.save(doc)}:
            raise AssertionError("sync-b: a joiner's save() bytes differ")
        bundle = len(hub._ckpt_cache["doc"][2])
    finally:
        M.uuid.reset()
    out = {"chars": n_base, "history": history, "peers": n_peers,
           "threshold": threshold, "storm_s": storm_s, "serve_s": serve_s,
           "engine_reads_s": engine_read_s,
           "captures": captures, "cached_serves": cached,
           "bundle_b64_bytes": bundle}
    log(f"sync-b join storm ({card}): {n_peers} fresh peers joined a "
        f"{history}-change history in one batched() window in "
        f"{storm_s:.3f} s (serve and restore {serve_s:.3f} s); "
        f"{captures} capture, {cached} cached serves of a {bundle}-byte "
        "base64 bundle; every peer restored on the device, texts equal")
    return out, (am.save(doc), want)


def sync_chaos(torch, M, card: str, device, n_base: int,
               n_edits: int) -> tuple:
    """sync-c: two DocSets on `device`, each holding cfg7's n_base-char
    Text, each with a Connection over a ResilientChannel over
    wan_pair(profile="cross_region", seed=0); both sides make n_edits
    concurrent 10-char inserts, one pump round after each pair, then pump
    until both are idle. The replicas must hold the same text, clock and
    changes. Returns the record and what the CPU backend's run must
    equal: each replica's save() bytes, the text, the links' fault
    counts and the channels' stats."""
    am = M.am
    res = am.resilience
    be = am.backend.backend_for(device)
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    _pinned_uuids(M)
    try:
        origin = am.change(am.init({"actorId": "origin", "backend": be}),
                           lambda d: d.__setitem__("t", am.Text("x" * n_base)))
        base = am.get_all_changes(origin)
        sides = {}
        for name in ("left", "right"):
            ds = am.DocSet(backend=be)
            ds.set_doc("doc", am.apply_changes(
                am.init({"actorId": name, "backend": be}), base))
            sides[name] = ds
        chans = {}
        fwd, rev = res.wan_pair(lambda env: chans["right"].on_wire(env),
                                lambda env: chans["left"].on_wire(env),
                                profile="cross_region", seed=0)
        chans["left"] = res.ResilientChannel(fwd.send, None, seed=1)
        chans["right"] = res.ResilientChannel(rev.send, None, seed=2)
        for name in ("left", "right"):
            conn = am.Connection(sides[name], chans[name].send)
            chans[name]._deliver = conn.receive_msg
            conn.open()

        def step():
            fwd.pump()
            rev.pump()
            chans["left"].tick()
            chans["right"].tick()

        def idle():
            return fwd.idle and rev.idle and all(c.idle
                                                 for c in chans.values())
        sync()
        t = time.perf_counter()
        rounds = 0
        for i in range(n_edits):
            for name, at, word in (("left", n_base // 20, "helloworld"),
                                   ("right", n_base // 2, "HELLOWORLD")):
                ds = sides[name]
                ds.set_doc("doc", am.change(ds.get_doc("doc"), lambda d,
                                            p=at + 11 * i, w=word:
                                            d["t"].insert_at(p, *w)))
            step()
            rounds += 1
        edit_rounds = rounds
        while not idle():
            step()
            rounds += 1
            if rounds > 20_000:
                raise AssertionError("sync-c: the chaos pair never went "
                                     "idle")
        texts = {n: str(ds.get_doc("doc")["t"]) for n, ds in sides.items()}
        sync()
        chaos_s = time.perf_counter() - t
        saves = {n: am.save(ds.get_doc("doc")) for n, ds in sides.items()}
        # each replica's history is in its own arrival order (as in the
        # JAX package), so the two save() byte strings differ; the text,
        # the clocks and the set of changes must not
        held = {n: sorted(json.dumps(c, sort_keys=True)
                          for c in json.loads(saves[n])["changes"])
                for n in sides}
        clocks = {n: am.frontend.get_backend_state(ds.get_doc("doc")).clock
                  for n, ds in sides.items()}
        if texts["left"] != texts["right"] or held["left"] != \
                held["right"] or clocks["left"] != clocks["right"]:
            raise AssertionError("sync-c: the replicas differ after the "
                                 "chaos session")
        if len(texts["left"]) != n_base + 2 * 10 * n_edits:
            raise AssertionError("sync-c: the merged text has the wrong "
                                 "length")
        if not all(_on_device(M, ds.get_doc("doc"), device)
                   for ds in sides.values()):
            raise AssertionError("sync-c: a replica left the device")
        link_stats = {"fwd": dict(fwd.stats), "rev": dict(rev.stats)}
        chan_stats = {n: dict(c.stats) for n, c in chans.items()}
    finally:
        M.uuid.reset()
    out = {"chars": n_base, "edits_per_side": n_edits, "chaos_s": chaos_s,
           "rounds": rounds, "rounds_after_edits": rounds - edit_rounds,
           "retransmits": sum(c["retransmits"] for c in chan_stats.values()),
           "links": link_stats, "channels": chan_stats}
    log(f"sync-c chaos ({card}): {n_edits} concurrent edits a side over "
        f"wan_pair(cross_region, seed=0) converged in {rounds} pump "
        f"rounds ({rounds - edit_rounds} after the last edit), "
        f"{out['retransmits']} retransmits, {chaos_s:.3f} s; fwd "
        f"{link_stats['fwd']}, rev {link_stats['rev']}; the replicas hold "
        f"the same text, clock and {len(held['left'])} changes")
    return out, (saves["left"], saves["right"], texts["left"], link_stats,
                 chan_stats)


def sync_phase(torch, M, card: str, device=None, n_base: int = API_TEXT,
               n_peers: int = SYNC_PEERS, n_changes: int = SYNC_CHANGES,
               n_storm: int = SYNC_STORM, storm_min: int = SYNC_STORM_MIN,
               chaos_edits: int = SYNC_CHAOS_EDITS, twins=None) -> dict:
    """The sync tier on `device`: sync-a (cfg9's fan-out on cfg7's text,
    a reconnect, a late full-history join), sync-b (a join storm served
    from one snapshot) and sync-c (two replicas under WAN chaos). On the
    card each part also runs as the same stream on the CPU backend in
    `twins`' worker (a CpuTwins) while the card's parts go on, and the
    card's texts and save() bytes must equal the CPU runs'. The kernel
    counts are set to 0 before the phase and read after the card's
    parts. Raises on any failed check."""
    cuda = torch.device(device or "cuda").type == "cuda"
    if cuda:
        wants = [twins.submit("sync_fanout", "cpu backend", "cpu", n_base,
                              n_peers, n_changes, item=1),
                 twins.submit("sync_storm", "cpu backend", "cpu", n_base,
                              n_changes, n_storm, storm_min, item=1),
                 twins.submit("sync_chaos", "cpu backend", "cpu", n_base,
                              chaos_edits, item=1)]
        torch.cuda.synchronize()
    t_phase = time.perf_counter()
    M.S.reset_launches()
    a, got_a = sync_fanout(torch, M, card, device, n_base, n_peers,
                           n_changes)
    b, got_b = sync_storm(torch, M, card, device, n_base, n_changes,
                          n_storm, storm_min)
    c, got_c = sync_chaos(torch, M, card, device, n_base, chaos_edits)
    if cuda:
        torch.cuda.synchronize()
    launches = dict(M.S.launches)
    shapes = {k: dict(v) for k, v in M.S.launch_shapes.items()}
    card_s = time.perf_counter() - t_phase
    if cuda:
        for part, got, want in zip(("sync-a", "sync-b", "sync-c"),
                                   (got_a, got_b, got_c), wants):
            if got != want.result():
                raise AssertionError(f"{part}: the card's texts or save() "
                                     "bytes differ from the CPU backend's")
        if not launches["multi_scan"] or not launches["fused_segment_scans"]:
            raise AssertionError(f"sync: a kernel missed the sync path: "
                                 f"{launches}")
    out = {"a": a, "b": b, "c": c, "launches": launches, "shapes": shapes,
           "card_s": card_s, "wall_s": time.perf_counter() - t_phase}
    log(f"sync phase launches: {launches}; card parts {card_s:.2f} s, "
        f"with the wait for the CPU backend's runs {out['wall_s']:.2f} s; "
        "texts and save() bytes equal to the CPU backend's")
    log("sync record: " + json.dumps(dict(out, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in shapes.items()}), default=str))
    return out


# --- the sharded serving tier (bench.py measure_sharded and measure_residency)

def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _mesh_digests(mesh, ids) -> dict:
    """Every doc's capture() bytes, as sha256 digests."""
    return {d: _digest(mesh.capture(d)) for d in ids}


def _sync_lanes(torch, mesh):
    """The rep barrier: every lane's stream, then the device."""
    for lane in mesh.lanes:
        if lane.stream is not None:
            lane.stream.synchronize()
    if any(lane.stream is not None for lane in mesh.lanes):
        torch.cuda.synchronize()


def _check_lane_tables(mesh):
    """No lane of the mesh holds a table off its own device."""
    for lane in mesh.lanes:
        for d, doc in lane.docs.items():
            for t in (doc._dev or {}).values():
                if t.device.type != lane.device.type:
                    raise AssertionError(f"{d} on lane {lane.index} holds a "
                                         f"table on {t.device}")


def _mesh_leg(torch, M, device, kind: str, doc_ids, n_lanes: int,
              capacity: int, seed, reps, n_run: int, warmup: int,
              mid: int = None, parallel=None) -> tuple:
    """One shard-a leg: the seed round, then reps[:n_run] (the first
    `warmup` untimed), each rep under bench.py's gc discipline and ended
    by a barrier on every lane's stream. `parallel` sets
    AMTPU_PARALLEL_LANES for the leg (None: the default). Returns (record,
    digests at the end, digests after `mid` reps or None)."""
    import gc
    t_leg = time.perf_counter()
    cuda = torch.device(device or "cuda").type == "cuda"
    prior = os.environ.get("AMTPU_PARALLEL_LANES")
    if parallel is not None:
        os.environ["AMTPU_PARALLEL_LANES"] = "1" if parallel else "0"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    mesh = M.shard.ShardedDocSet(
        n_shards=n_lanes, doc_kind=kind, capacity=capacity,
        devices=None if cuda else [torch.device("cpu")])
    rates, mid_digests = [], None
    gc_was = gc.isenabled()
    try:
        mesh.deliver_round(seed)
        _sync_lanes(torch, mesh)
        for i, rounds in enumerate(reps[:n_run]):
            if mid is not None and i == mid:
                mid_digests = _mesh_digests(mesh, doc_ids)
            gc.collect()
            gc.disable()
            admitted = 0
            t0 = time.perf_counter()
            for chunk in rounds:
                admitted += mesh.deliver_round(chunk)
            _sync_lanes(torch, mesh)
            dt = time.perf_counter() - t0
            if gc_was:
                gc.enable()
            if i >= warmup:
                rates.append(admitted / dt)
        if mid is not None and mid == n_run:
            mid_digests = _mesh_digests(mesh, doc_ids)
        _check_lane_tables(mesh)
        lane_stats = [dict(lane.stats) for lane in mesh.lanes]
        tel = mesh.telemetry
        agg = tel.span_aggregates().get(("mesh", "barrier_wait"))
        rec = {
            "lanes": n_lanes, "docs": len(doc_ids), "reps": len(rates),
            "warmup": warmup, "ops_per_rep": admitted,
            "ops_per_s_median": float(np.median(rates)),
            "ops_per_s_min": min(rates), "ops_per_s_max": max(rates),
            "rates": rates,
            "stacked": sum(s["stacked_applies"] for s in lane_stats),
            "per_object": sum(s["per_object_applies"] for s in lane_stats),
            "spread": mesh.placement.spread(doc_ids),
            "device_bytes": sum(lane.device_footprint()["device_bytes"]
                                for lane in mesh.lanes),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if cuda else None),
            "workers": mesh._executor is not None,
            "barrier_wait": None if agg is None else {
                "count": agg["count"], "total_s": agg["total_ns"] / 1e9,
                "p50_ms": tel.quantile_ns("mesh", "barrier_wait", 0.5) / 1e6,
                "p99_ms": tel.quantile_ns("mesh", "barrier_wait",
                                          0.99) / 1e6}}
        if cuda:
            streams = {lane.stream.cuda_stream for lane in mesh.lanes}
            if len(streams) != n_lanes:
                raise AssertionError(f"{n_lanes} lanes on {len(streams)} "
                                     "streams")
        digests = _mesh_digests(mesh, doc_ids)
        rec["leg_s"] = time.perf_counter() - t_leg
    finally:
        if gc_was:
            gc.enable()
        mesh.close()
        if parallel is not None:
            if prior is None:
                os.environ.pop("AMTPU_PARALLEL_LANES", None)
            else:
                os.environ["AMTPU_PARALLEL_LANES"] = prior
    return rec, digests, mid_digests


def shard_population(torch, M, card: str, device, kind: str, n_lanes: int,
                     per_lane: int, capacity: int, n_rounds: int,
                     warmup: int, reps: int, single_warmup: int,
                     single_reps: int, cpu_per_lane: int) -> dict:
    """shard-a for one population (bench.py _sharded_ab): the n-lane mesh
    with the lane workers, the same mesh sequential (the default for lanes
    of one device), and one lane, on the
    identical stream; every doc's capture equal across the legs (the one
    lane's at the point its cut reps end) and equal to an n-lane CPU mesh
    fed the same stream for `cpu_per_lane` docs of every lane."""
    cuda = torch.device(device or "cuda").type == "cuda"
    doc_ids = [f"{kind[0]}doc-{i:05d}" for i in range(n_lanes * per_lane)]
    seed, all_reps = shard_stream(doc_ids if kind == "text" else [],
                                  doc_ids if kind == "map" else [], 64,
                                  n_rounds, warmup + reps)
    n_single = single_warmup + single_reps
    par, par_d, par_mid = _mesh_leg(
        torch, M, device, kind, doc_ids, n_lanes, capacity, seed, all_reps,
        warmup + reps, warmup, mid=n_single, parallel=True)
    seq, seq_d, _ = _mesh_leg(
        torch, M, device, kind, doc_ids, n_lanes, capacity, seed, all_reps,
        warmup + reps, warmup, parallel=None)
    one, one_d, _ = _mesh_leg(
        torch, M, device, kind, doc_ids, 1, capacity, seed, all_reps,
        n_single, single_warmup)
    if not par["workers"] or seq["workers"]:
        raise AssertionError(f"shard-a {kind}: the legs did not take the "
                             "worker / sequential paths (the lanes of one "
                             "device default to the sequential loop)")
    for name, leg in (("workers", par), ("sequential", seq)):
        if leg["per_object"] or not leg["stacked"]:
            raise AssertionError(f"shard-a {kind} {name}: a mesh lane fell "
                                 f"off the stacked path: {leg}")
    if cuda and (one["stacked"] or not one["per_object"]):
        raise AssertionError(f"shard-a {kind}: one lane did not degrade to "
                             f"per-object: {one}")
    if par_d != seq_d:
        raise AssertionError(f"shard-a {kind}: the worker and sequential "
                             "legs' captures differ")
    if one_d != par_mid:
        raise AssertionError(f"shard-a {kind}: the one-lane leg's captures "
                             "differ from the mesh's at the same point")
    cpu_ids = None
    if cuda:
        by_lane = {}
        for d in doc_ids:
            by_lane.setdefault(M.shard.hash_shard(d, n_lanes), []).append(d)
        cpu_ids = sorted(d for ids in by_lane.values()
                         for d in ids[:cpu_per_lane])
        keep = set(cpu_ids)
        sub = lambda chunk: {d: v for d, v in chunk.items()  # noqa: E731
                             if d in keep}
        _, cpu_d, _ = _mesh_leg(
            torch, M, "cpu", kind, cpu_ids, n_lanes, capacity, sub(seed),
            [[sub(c) for c in rounds] for rounds in all_reps],
            warmup + reps, warmup)
        if any(cpu_d[d] != par_d[d] for d in cpu_ids):
            raise AssertionError(f"shard-a {kind}: captures differ from the "
                                 "CPU mesh's")
    out = {"kind": kind, "capacity": capacity, "rounds_per_rep": n_rounds,
           "workers": par, "sequential": seq, "one_lane": one,
           "scaleup_workers": par["ops_per_s_median"]
           / one["ops_per_s_median"],
           "scaleup_sequential": seq["ops_per_s_median"]
           / one["ops_per_s_median"],
           "cpu_docs": len(cpu_ids) if cpu_ids else 0,
           "one_lane_cut": {"warmup": single_warmup, "reps": single_reps,
                            "captures_at_rep": n_single}}
    log(f"shard-a {kind} ({card}): {len(doc_ids)} docs on {n_lanes} lanes, "
        f"workers median {par['ops_per_s_median']:.0f} admitted ops/s "
        f"({par['ops_per_s_min']:.0f}-{par['ops_per_s_max']:.0f}), "
        f"sequential {seq['ops_per_s_median']:.0f} "
        f"({seq['ops_per_s_min']:.0f}-{seq['ops_per_s_max']:.0f}), one "
        f"lane {one['ops_per_s_median']:.0f} "
        f"({one['ops_per_s_min']:.0f}-{one['ops_per_s_max']:.0f}); "
        f"scale-up {out['scaleup_workers']:.2f}x / "
        f"{out['scaleup_sequential']:.2f}x; applies stacked "
        f"{par['stacked']} / {seq['stacked']}, one lane per-object "
        f"{one['per_object']}; barrier_wait {par['barrier_wait']}; "
        f"captures equal across legs and to the CPU mesh "
        f"({out['cpu_docs']} docs)")
    return out


def shard_router(torch, M, device, text_ids, capacity: int, n_lanes: int,
                 hot_ops: int, max_hot: int, n_hot: int = None) -> tuple:
    """shard-b on one mesh: a premature seq parks at the router and drains
    on the missing one, a forced migration mid-stream, then the rebalancer
    (ratio 2.0, min_ops 32) and one hot doc hammered until it moves (or,
    given `n_hot`, for exactly that many rounds). Returns (record, texts,
    capture digests)."""
    cuda = torch.device(device or "cuda").type == "cuda"
    mesh = M.shard.ShardedDocSet(
        n_shards=n_lanes, capacity=capacity,
        devices=None if cuda else [torch.device("cpu")])
    park, moved, hot, rec = text_ids[0], text_ids[1], text_ids[2], {}
    try:
        mesh.deliver_round(stack_text_round(text_ids, 1, 1, 64))
        r_a = stack_text_round(text_ids, 2, 33, 4)
        r_a[park] = stack_text_round([park], 3, 35, 4)[park]
        mesh.deliver_round(r_a)
        rec["parked"] = mesh.quarantined(park)
        r_b = stack_text_round(text_ids, 3, 35, 4)
        r_b[park] = stack_text_round([park], 2, 33, 4)[park]
        mesh.deliver_round(r_b)
        rec["after_drain"] = mesh.quarantined(park)
        if n_lanes > 1:
            home = mesh.placement.shard_of(moved)
            rec["forced_migration"] = mesh.migrate(
                moved, (home + 3) % n_lanes)
        mesh.deliver_round(stack_text_round(text_ids, 4, 37, 4))
        reb = mesh.attach_rebalancer(ratio=2.0, min_ops=32)
        home = mesh.placement.shard_of(hot)
        base, rounds = 39, 0
        while rounds < (n_hot if n_hot is not None else max_hot):
            mesh.deliver_round(stack_text_round([hot], 5 + rounds, base,
                                                hot_ops))
            base += hot_ops // 2
            rounds += 1
            if n_hot is None and reb.stats["migrations"]:
                break
        rec.update({"hot_rounds": rounds, "hot_home": home,
                    "hot_now": mesh.placement.shard_of(hot),
                    "rebalancer": dict(reb.stats),
                    "window_loads": reb.window_loads(),
                    "mesh_stats": dict(mesh.stats),
                    "placement": mesh.placement.table()})
        _check_lane_tables(mesh)
        texts = mesh.texts()
        digests = _mesh_digests(mesh, text_ids)
    finally:
        mesh.close()
    return rec, texts, digests


def shard_residency(torch, M, device, n_docs: int, budget_docs: int,
                    rounds_per_rep: int, reps: int, capacity: int,
                    revisit_lag: int, cold_after: int,
                    warmup: int = 1) -> tuple:
    """shard-c (bench.py measure_residency): the unbounded reference mesh
    first, then the same schedule through a 2-lane mesh with the pager
    attached at a budget of `budget_docs` docs' bytes (the reference's
    largest per-doc device_bytes), spilling to a temporary directory.
    Returns (record, capture digests)."""
    import tempfile
    cuda = torch.device(device or "cuda").type == "cuda"
    devices = None if cuda else [torch.device("cpu")]
    n_hot = max(2, budget_docs // 2)
    doc_ids = [f"rz-{i:05d}" for i in range(n_docs)]
    hot_ids, cold_ids = doc_ids[:n_hot], doc_ids[n_hot:]
    seqs = dict.fromkeys(doc_ids, 0)
    ctrs = dict.fromkeys(doc_ids, 0)
    schedule = []
    for r in range((warmup + reps) * rounds_per_rep):
        picks = [hot_ids[(r + k) % n_hot] for k in range(2)]
        picks.append(cold_ids[r % len(cold_ids)])
        if r >= revisit_lag:
            picks.append(cold_ids[(r - revisit_lag) % len(cold_ids)])
        chunk = {}
        for d in dict.fromkeys(picks):
            seqs[d] += 1
            chunk.update(stack_text_round([d], seqs[d], ctrs[d] + 1, 8))
            ctrs[d] += 4
        schedule.append(chunk)
    touched = [d for d in doc_ids if seqs[d]]
    ref = M.shard.ShardedDocSet(n_shards=2, capacity=capacity,
                                devices=devices)
    for chunk in schedule:
        ref.deliver_round(chunk)
    ref_digests = _mesh_digests(ref, touched)
    per_doc = max(doc.device_footprint()["device_bytes"]
                  for lane in ref.lanes for doc in lane.docs.values())
    ref.close()
    del ref
    budget = budget_docs * per_doc
    if len(touched) * per_doc < 10 * budget:
        raise AssertionError("shard-c: population under 10x the budget")
    M.dt.REGISTRY.clear_session()
    h2d0 = M.accounting.snapshot()["h2d_bytes"]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as spill:
        mesh = M.shard.ShardedDocSet(n_shards=2, capacity=capacity,
                                     devices=devices)
        res = mesh.attach_residency(budget_bytes=budget, spill_dir=spill,
                                    cold_after=cold_after)
        paged_table_bytes = [0]
        page_in = res.page_in

        def metered_page_in(doc_id, *a, **kw):
            lane = page_in(doc_id, *a, **kw)
            if lane is not None:
                paged_table_bytes[0] += lane.docs[doc_id].device_footprint()[
                    "table_bytes"]
            return lane
        res.page_in = metered_page_in
        rates = []
        try:
            for i in range(warmup + reps):
                admitted = 0
                t0 = time.perf_counter()
                for chunk in schedule[i * rounds_per_rep:
                                      (i + 1) * rounds_per_rep]:
                    admitted += mesh.deliver_round(chunk)
                    peak = M.dt.REGISTRY.footprint()["peak_device_bytes"]
                    if peak > budget:
                        raise AssertionError(f"shard-c: peak {peak} > "
                                             f"budget {budget}")
                _sync_lanes(torch, mesh)
                if i >= warmup:
                    rates.append(admitted / (time.perf_counter() - t0))
            h2d = M.accounting.snapshot()["h2d_bytes"] - h2d0
            m = res.metrics()
            if m["budget_overruns"] or not (
                    m["page_ins"] and m["page_outs"] and m["cold_ages"]
                    and m["cold_loads"]):
                raise AssertionError(f"shard-c: paging incomplete: {m}")
            acct = res.accounting()
            if sorted(acct["hot"] + acct["warm"] + acct["cold"]) != \
                    sorted(touched):
                raise AssertionError("shard-c: the tier ledger lost docs")
            _check_lane_tables(mesh)
            digests = _mesh_digests(mesh, touched)
            if digests != ref_digests:
                raise AssertionError("shard-c: captures differ from the "
                                     "unbounded reference")
            peak = M.dt.REGISTRY.footprint()["peak_device_bytes"]
            if peak > budget:
                raise AssertionError(f"shard-c: peak {peak} > {budget}")
            rec = {
                "docs": n_docs, "touched": len(touched),
                "budget_docs": budget_docs, "per_doc_bytes": per_doc,
                "budget_bytes": budget, "peak_resident_bytes": peak,
                "rounds": len(schedule), "reps": len(rates),
                "ops_per_s_median": float(np.median(rates)),
                "ops_per_s_min": min(rates), "ops_per_s_max": max(rates),
                "page_in_p99_ms": res.page_in_p99_ms(),
                "hit_rate": res.hit_rate(),
                "warm_bytes": acct["warm_bytes"],
                "cold_bytes": acct["cold_bytes"],
                "h2d_bytes": h2d, "paged_table_bytes": paged_table_bytes[0],
                "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                         if cuda else None),
                "stats": {k: v for k, v in m.items()
                          if k not in ("page_in_p99_ms", "hit_rate")}}
        finally:
            mesh.close()
    return rec, digests


def shard_phase(torch, M, card: str, device=None, n_lanes: int = MESH_LANES,
                map_per_lane: int = SHARD_MAP_DOCS,
                text_per_lane: int = SHARD_TEXT_DOCS,
                capacity: int = SHARD_CAP, n_rounds: int = SHARD_ROUNDS,
                warmup: int = MESH_WARMUP, reps: int = MESH_REPS,
                single_warmup: int = ONE_LANE_WARMUP,
                single_reps: int = ONE_LANE_REPS,
                cpu_per_lane: int = MESH_CPU_DOCS, hot_ops: int = HOT_OPS,
                max_hot: int = HOT_ROUNDS, res_docs: int = RES_DOCS,
                res_budget_docs: int = RES_BUDGET_DOCS,
                res_rounds: int = RES_ROUNDS, res_reps: int = RES_REPS,
                res_cap: int = RES_CAP, res_lag: int = RES_LAG,
                res_cold_after: int = RES_COLD_AFTER) -> dict:
    """The sharded serving tier on `device`: shard-a cfg12's map and text
    populations on an n-lane mesh (lanes are streams of the card) with
    the workers, sequentially and on one lane; shard-b the router's
    park/drain, a forced migration and one rebalancer migration, against
    a one-lane run and the CPU; shard-c cfg18 through the pager against
    the unbounded reference and the CPU. The kernel counts are set to 0
    before the card's parts and read after them. Raises on any failed
    check."""
    cuda = torch.device(device or "cuda").type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t_phase = time.perf_counter()
    M.S.reset_launches()
    a = {kind: shard_population(
        torch, M, card, device, kind, n_lanes, per, capacity, n_rounds,
        warmup, reps, single_warmup, single_reps, cpu_per_lane)
        for kind, per in (("map", map_per_lane), ("text", text_per_lane))}
    t_b = time.perf_counter()
    text_ids = [f"tdoc-{i:05d}" for i in range(n_lanes * text_per_lane)]
    b, b_texts, b_dig = shard_router(torch, M, device, text_ids, capacity,
                                     n_lanes, hot_ops, max_hot)
    if (b["parked"], b["after_drain"]) != (1, 0) or \
            not b.get("forced_migration") or \
            b["rebalancer"]["migrations"] != 1 or \
            b["mesh_stats"]["migrations"] != 2 or \
            b["hot_now"] == b["hot_home"]:
        raise AssertionError(f"shard-b: {b}")
    _, one_texts, one_dig = shard_router(torch, M, device, text_ids,
                                         capacity, 1, hot_ops, max_hot,
                                         n_hot=b["hot_rounds"])
    if (one_texts, one_dig) != (b_texts, b_dig):
        raise AssertionError("shard-b: texts or captures differ from the "
                             "one-lane run")
    b["part_s"] = time.perf_counter() - t_b
    t_c = time.perf_counter()
    c, c_dig = shard_residency(torch, M, device, res_docs, res_budget_docs,
                               res_rounds, res_reps, res_cap, res_lag,
                               res_cold_after)
    c["part_s"] = time.perf_counter() - t_c
    if cuda:
        torch.cuda.synchronize()
    launches = dict(M.S.launches)
    shapes = {k: dict(v) for k, v in M.S.launch_shapes.items()}
    card_s = time.perf_counter() - t_phase
    if cuda:
        _, cpu_texts, cpu_dig = shard_router(
            torch, M, "cpu", text_ids, capacity, n_lanes, hot_ops, max_hot,
            n_hot=b["hot_rounds"])
        if (cpu_texts, cpu_dig) != (b_texts, b_dig):
            raise AssertionError("shard-b: texts or captures differ from the "
                                 "CPU run")
        c_cpu, c_cpu_dig = shard_residency(
            torch, M, "cpu", res_docs, res_budget_docs, res_rounds, res_reps,
            res_cap, res_lag, res_cold_after)
        if c_cpu_dig != c_dig:
            raise AssertionError("shard-c: captures differ from the CPU run")
        if c_cpu["stats"] != c["stats"]:
            raise AssertionError(f"shard-c: the pager's counters differ "
                                 f"from the CPU run's: {c['stats']} != "
                                 f"{c_cpu['stats']}")
        c["cpu_per_doc_bytes"] = c_cpu["per_doc_bytes"]
        if not launches["multi_scan"]:
            raise AssertionError(f"shard: multi_scan missed the path: "
                                 f"{launches}")
    out = {"a": a, "b": b, "c": c, "launches": launches, "shapes": shapes,
           "card_s": card_s, "wall_s": time.perf_counter() - t_phase}
    log(f"shard-b ({card}): parked {b['parked']} then {b['after_drain']}, "
        f"forced migration {b['forced_migration']}, rebalancer "
        f"{b['rebalancer']} after {b['hot_rounds']} hot rounds (lane "
        f"{b['hot_home']} -> {b['hot_now']}); texts and captures equal to "
        "the one-lane run and the CPU")
    log(f"shard-c ({card}): {c['ops_per_s_median']:.0f} ops/s through the "
        f"pager ({c['ops_per_s_min']:.0f}-{c['ops_per_s_max']:.0f}), "
        f"page-in p99 {c['page_in_p99_ms']} ms, hit rate {c['hit_rate']}, "
        f"peak {c['peak_resident_bytes']} <= budget {c['budget_bytes']} "
        f"({c['budget_docs']} x {c['per_doc_bytes']} B), warm "
        f"{c['warm_bytes']} B, cold {c['cold_bytes']} B, h2d "
        f"{c['h2d_bytes']} B ({c['paged_table_bytes']} B of paged-in "
        f"tables), max_memory_allocated {c['max_memory_allocated']}; "
        f"stats {c['stats']}")
    log(f"shard phase launches: {launches}; card parts {card_s:.2f} s, "
        f"with the CPU runs {out['wall_s']:.2f} s")
    log("shard record: " + json.dumps(dict(out, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in shapes.items()}), default=str))
    return out


def lane_probe(torch, M, card: str, device=None, n_lanes: int = MESH_LANES,
               per_lane: int = SHARD_MAP_DOCS, pairs: int = 3) -> dict:
    """Where a lane's round goes with the lane workers on and off:
    shard-a's map population (its 640 docs a lane at capacity 2,048,
    seeded with the 64-key space) on `n_lanes` lanes of the card, served
    rounds of 2 ops a doc alternately with the workers
    (AMTPU_PARALLEL_LANES=1) and sequentially (=0) on the same mesh,
    `pairs` times, two rounds each. Every `ShardLane.ingest` is timed on
    the thread that runs it, in wall time and in that thread's CPU time
    (`time.thread_time`), and every round in wall time and in the
    process's CPU time over all threads (`time.process_time`): a lane
    waiting for the interpreter lock shows wall far above its CPU time,
    and host waits that spin on the card show CPU time close to wall time
    on every thread that waits."""
    import threading
    ids = [f"mdoc-{i:05d}" for i in range(n_lanes * per_lane)]
    cuda = torch.device(device or "cuda").type == "cuda"
    mesh = M.shard.ShardedDocSet(
        n_shards=n_lanes, doc_kind="map", capacity=SHARD_CAP,
        devices=None if cuda else [torch.device("cpu")])
    samples = {"1": [], "0": []}
    lock = threading.Lock()
    mode = {"flag": "0"}
    for lane in mesh.lanes:
        def timed(deliveries, stats=None, _ingest=lane.ingest):
            w0, c0 = time.perf_counter(), time.thread_time()
            try:
                return _ingest(deliveries, stats=stats)
            finally:
                w, c = time.perf_counter() - w0, time.thread_time() - c0
                with lock:
                    samples[mode["flag"]].append((w, c))
        lane.ingest = timed
    prior = os.environ.get("AMTPU_PARALLEL_LANES")
    rounds = {"1": [], "0": []}
    seq = 2
    try:
        mesh.deliver_round(stack_map_round(ids, 1, 64, 64))
        _sync_lanes(torch, mesh)
        samples["0"].clear()           # the seed round's ingests
        for _ in range(pairs):
            for flag in ("1", "0"):
                os.environ["AMTPU_PARALLEL_LANES"] = flag
                mode["flag"] = flag
                for _r in range(2):
                    chunk = stack_map_round(ids, seq, 64, 2)
                    t0, c0 = time.perf_counter(), time.process_time()
                    mesh.deliver_round(chunk)
                    _sync_lanes(torch, mesh)
                    rounds[flag].append((time.perf_counter() - t0,
                                         time.process_time() - c0))
                    seq += 1
    finally:
        mesh.close()
        if prior is None:
            os.environ.pop("AMTPU_PARALLEL_LANES", None)
        else:
            os.environ["AMTPU_PARALLEL_LANES"] = prior
    out = {"lanes": n_lanes, "docs": len(ids), "card": card}
    for flag, name in (("1", "workers"), ("0", "sequential")):
        w, c = zip(*samples[flag])
        rw, rc = zip(*rounds[flag])
        out[name] = {"round_s": list(rw), "round_cpu_s": list(rc),
                     "round_s_median": float(np.median(rw)),
                     "round_cpu_s_median": float(np.median(rc)),
                     "lane_ingest_wall_s_median": float(np.median(w)),
                     "lane_ingest_cpu_s_median": float(np.median(c)),
                     "lane_ingests": len(w)}
        log(f"lane probe {name} ({card}): round "
            f"{out[name]['round_s_median']:.3f} s wall, "
            f"{out[name]['round_cpu_s_median']:.3f} s process CPU; lane "
            f"ingest {out[name]['lane_ingest_wall_s_median']:.3f} s wall, "
            f"{out[name]['lane_ingest_cpu_s_median']:.3f} s thread CPU")
    return out


def blocking_sync() -> int:
    """Make every host wait on card 0 block instead of spin: the
    primary context's scheduling flag set to CU_CTX_SCHED_BLOCKING_SYNC
    through the driver, before the context is made. Returns the flags
    the primary context then holds."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    dev, flags, active = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
    for rc in (cu.cuInit(0), cu.cuDeviceGet(ctypes.byref(dev), 0),
               cu.cuDevicePrimaryCtxSetFlags_v2(dev, 0x04),
               cu.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags),
                                             ctypes.byref(active))):
        if rc != 0:
            raise RuntimeError(f"CUDA driver call failed: {rc}")
    if flags.value & 0x07 != 0x04:
        raise RuntimeError(f"primary context flags {flags.value:#x}")
    return flags.value


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


# --- the mesh path (parallel/, sharded_fused_scans, DeviceTextDocSet(mesh=),
# shard/audit.py) ------------------------------------------------------------

def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _virtual(M, dev, n: int, doc_axis: int = 1):
    """A mesh of n virtual shards of one device."""
    return M.pmesh.make_mesh(n, doc_axis, devices=[dev] * n)


def _moved(M) -> dict:
    return {k: (M.pmesh.calls[k], M.pmesh.moved_bytes[k])
            for k in M.pmesh.calls}


def _moved_since(M, before: dict) -> dict:
    """Exchange calls and bytes since `before` (`_moved`), zeros dropped."""
    now = _moved(M)
    return {k: {"calls": now[k][0] - before[k][0],
                "bytes": now[k][1] - before[k][1]}
            for k in now if now[k] != before[k]}


def mesh_kernel_checks(torch, M, dev, sizes=(N_MERGE, 1_048_576),
                       shards=MESH_SHARDS, ragged=MESH_RAGGED,
                       rows=MESH_ROW_CASES, row_shards=4) -> list:
    """15(a): the kernel pair (`fs_totals` + carry-in `fs_scan`) over
    2, 4 and 8 virtual shards of `dev` at each size, over 8 at a ragged
    size (a shard that is no whole number of tiles), and the row form
    over `row_shards` elem shards at each (D, C) of `rows`: every output
    bit-exact against `sharded_fused_scans_plain` and the unsharded
    `fused_segment_scans` (kernel on a card). Returns the checked cases,
    each with the form its shards took."""
    rng = np.random.default_rng(15)
    S = M.S
    cases = []
    for C in tuple(sizes) + (ragged,):
        chain, has = _fs_inputs(torch, rng, C, dev)
        ne = C - C // 20
        whole = S.fused_segment_scans(chain, has, ne)
        for n in (shards if C != ragged else (max(shards),)):
            got = S.sharded_fused_scans(_virtual(M, dev, n), chain, has, ne)
            plain = S.sharded_fused_scans_plain(chain, has, ne, n)
            _sync(torch, dev)
            for g, p, w in zip(got, plain, whole):
                if g.n_shards != n or not torch.equal(g.gather(dev), p) \
                        or not torch.equal(p, w):
                    raise AssertionError(f"sharded_fused_scans differs at "
                                         f"C={C} over {n} shards")
            cases.append([C, n, S.FORMS[S.fs_geometry(
                "fs_scan", 1, C // n).form]])
    for D, C in rows:
        chain = torch.from_numpy(rng.random((D, C)) < 0.9).to(dev)
        has = torch.from_numpy(rng.random((D, C)) < 0.95).to(dev)
        n = rng.integers(0, C + 1, D).astype(np.int32)
        n[0], n[-1] = 0, C
        ne = torch.from_numpy(n).to(dev)
        got = S.sharded_fused_scans(_virtual(M, dev, row_shards), chain, has,
                                    ne)
        plain = S.sharded_fused_scans_plain(chain, has, ne, row_shards)
        whole = S.fused_segment_scans(chain, has, ne)
        _sync(torch, dev)
        for g, p, w in zip(got, plain, whole):
            if not torch.equal(g.gather(dev), p) or not torch.equal(p, w):
                raise AssertionError(f"sharded_fused_scans rows differ at "
                                     f"({D}, {C}) over {row_shards} shards")
        cases.append([[D, C], row_shards, S.FORMS[S.fs_geometry(
            "fs_scan", D, C // row_shards).form]])
    log(f"15a sharded_fused_scans bit-exact vs plain and the unsharded "
        f"scans: {cases}")
    return cases


def _check_read(doc, mirror, want_sha, n_shards, codes, scalars):
    """15b's checks of one sharded read: the text's sha, the shards, the
    plan scalars against the mirror. Returns the scalars."""
    scal = np.asarray(scalars)
    fetched = np.asarray(codes)
    n_vis = int(scal[0])
    text = (fetched[:n_vis].tobytes().decode("ascii") if doc.all_ascii
            else "".join(chr(v) for v in fetched[:n_vis]))
    if sha(text) != want_sha or codes.n_shards != n_shards:
        raise AssertionError("15b: the sharded text differs from the "
                             "unsharded document's")
    if not (int(scal[1]) == int(scal[2]) == mirror.n_segs
            and int(scal[3]) == mirror.head_checksum()
            and int(scal[4]) == mirror.aux_checksum()):
        raise AssertionError(f"15b: plan scalars {scal} disagree with the "
                             "mirror")
    return scal


def mesh_materialize(torch, M, doc, dev, want_sha: str,
                     n_shards: int = 8) -> dict:
    """15(b): the headline document's codes-only materialization with
    its columns elem-sharded over n virtual shards and the segment plan
    replicated (`sharded_planned_materialize`); its text's sha must equal
    the unsharded document's."""
    mirror = doc.seg_mirror
    if mirror is None:
        raise AssertionError("15b: the headline document has no mirror")
    S_ = M.bucket(mirror.n_segs + 2, 64)
    segplan = mirror.plan(S_, doc.n_elems)
    tabs = doc._ensure_dev()
    cols = [tabs[k] for k in ("parent", "ctr", "actor", "value",
                              "has_value", "chain")]
    mesh = _virtual(M, dev, n_shards)
    secs = []
    for _ in range(2):                 # a cold read, then a warm one
        before = _moved(M)
        _sync(torch, dev)
        t0 = time.perf_counter()
        codes, scalars = M.pmesh.sharded_planned_materialize(
            mesh, *cols, doc.n_elems, segplan, S=S_, as_u8=doc.all_ascii)
        _sync(torch, dev)
        secs.append(time.perf_counter() - t0)
        moved = _moved_since(M, before)
        scal = _check_read(doc, mirror, want_sha, n_shards, codes, scalars)
    rec = {"capacity": int(cols[0].shape[0]), "n_shards": n_shards, "S": S_,
           "n_vis": int(scal[0]), "n_segs": int(scal[1]), "cold_s": secs[0],
           "warm_s": secs[1], "exchange": moved}
    log(f"15b sharded_planned_materialize of the {rec['n_vis']}-char "
        f"document over {n_shards} shards: cold {secs[0]:.4f} s, warm "
        f"{secs[1]:.4f} s, text sha256 {want_sha[:16]} as unsharded; "
        f"exchange of the warm read {moved}")
    return rec


def mesh_docset(torch, M, dev, n_docs: int = DOCSET_DOCS,
                n_actors: int = DOCSET_ACTORS, chars: int = DOCSET_CHARS,
                reps: int = DMESH_REPS, grid=MESH_DOCSET) -> dict:
    """15(c): run_all.py config3_docset through DeviceTextDocSet(mesh=)
    on a (doc, elem) mesh of virtual shards and on the machine's cards:
    build + planned texts() over fresh runs, then one corrupted-mirror
    call (the self-contained rows over the sharded scans); every texts()
    equal to the unsharded DocSet's."""
    ids = [f"d{d}" for d in range(n_docs)]
    batches = {f"d{d}": docset_batch(M.TB, M.C, f"d{d}", d, n_actors, chars)
               for d in range(n_docs)}
    cap = n_actors * chars + 64
    plain = M.DeviceTextDocSet(ids, capacity=cap, device=dev)
    plain.apply_batches(batches)
    want = plain.texts()
    cards = (M.pmesh.make_mesh() if torch.device(dev).type == "cuda"
             else M.pmesh.make_mesh(devices=[dev]))
    meshes = {f"{grid[0]}x{grid[1]} virtual":
              _virtual(M, dev, grid[0] * grid[1], grid[0]),
              f"{cards.shape['doc']}x{cards.shape['elem']} cards": cards}
    out = {}
    for label, mesh in meshes.items():
        runs = []
        for r in range(1 + reps):
            before = _moved(M)
            _sync(torch, dev)
            t0 = time.perf_counter()
            ds = M.DeviceTextDocSet(ids, capacity=cap, mesh=mesh)
            ds.apply_batches(batches)
            _sync(torch, dev)
            t1 = time.perf_counter()
            texts = ds.texts()
            t2 = time.perf_counter()
            if texts != want:
                raise AssertionError(f"15c {label} run {r}: texts differ "
                                     "from the unsharded DocSet's")
            if r:
                runs.append({"build_s": t1 - t0, "texts_s": t2 - t1,
                             "exchange": _moved_since(M, before)})
        m = ds._meta[1].mirror
        ds._meta[1].mirror = type(m)(np.append(m.heads, 3),
                                     np.append(m.par, 2),
                                     np.append(m.hctr, 99),
                                     np.append(m.hactor, 0))
        ds._meta[1].mirror.heads.sort()
        ds._codes_cache = None
        heals = heal_watch(logging)
        before = _moved(M)
        if ds.texts() != want or not any("diverged" in msg
                                         for msg in heals.records):
            raise AssertionError(f"15c {label}: the heal failed")
        logging.getLogger("automerge_tpu_torch.engine").removeHandler(heals)
        out[label] = {
            "mesh": dict(mesh.shape), "runs": runs,
            "build_s_median": float(np.median([x["build_s"] for x in runs])),
            "texts_s_median": float(np.median([x["texts_s"] for x in runs])),
            "heal_exchange": _moved_since(M, before),
            "n_shards": ds._dev["chain"].n_shards}
        log(f"15c DocSet(mesh={label}) cfg3 {n_docs} docs: build median "
            f"{out[label]['build_s_median']:.4f} s, texts() median "
            f"{out[label]['texts_s_median']:.4f} s over {reps} runs; "
            f"exchange a run {runs[-1]['exchange']}; heal exchange "
            f"{out[label]['heal_exchange']}; texts equal to the unsharded "
            "DocSet's")
    return out


def mesh_phase(torch, M, card: str, doc, want_sha: str, device=None,
               check_sizes=(N_MERGE, 1_048_576), ragged: int = MESH_RAGGED,
               docset: dict = None) -> dict:
    """Phase 15, the mesh path on `device`: (a) the kernel pair's checks
    (not counted), then with every count set to 0: (b) the headline
    document's elem-sharded planned materialization, (c) the cfg3
    DocSet on a mesh of virtual shards and on the machine's cards, (d)
    the dry run over 8 virtual shards and the commit-path audit over a
    doc-only mesh of the cards and of 8 virtual shards. Returns the
    record with the path's launches. Raises on any failed check."""
    dev = torch.device(device or "cuda")
    t_phase = time.perf_counter()
    checked = mesh_kernel_checks(torch, M, dev, check_sizes, ragged=ragged)
    _sync(torch, dev)
    M.S.reset_launches()
    M.pmesh.reset_counts()
    t_path = time.perf_counter()
    b = mesh_materialize(torch, M, doc, dev, want_sha)
    c = mesh_docset(torch, M, dev, **(docset or {}))
    t_d = time.perf_counter()
    M.dryrun.run(8, dev)
    cards = None if dev.type == "cuda" else M.audit.doc_mesh(
        devices=[dev])
    audits = {"cards": M.audit.commit_path_collectives(cards),
              "8 virtual": M.audit.commit_path_collectives(
                  M.audit.doc_mesh(8, devices=[dev] * 8))}
    for a in audits.values():
        M.audit.assert_zero_collectives(a)
    _sync(torch, dev)
    launches = dict(M.S.launches)
    shapes = {k: dict(v) for k, v in M.S.launch_shapes.items()}
    exchange = {k: {"calls": M.pmesh.calls[k],
                    "bytes": M.pmesh.moved_bytes[k]} for k in M.pmesh.calls}
    out = {"checked": checked, "materialize": b, "docset": c,
           "audit": audits, "dryrun_s": time.perf_counter() - t_d,
           "launches": launches, "shapes": shapes, "exchange": exchange,
           "path_s": time.perf_counter() - t_path,
           "wall_s": time.perf_counter() - t_phase}
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"mesh path: a kernel never launched: "
                             f"{launches}")
    log(f"mesh phase launches: {launches}; exchange {exchange}; audit "
        f"{audits}; dry run + audit {out['dryrun_s']:.2f} s; path "
        f"{out['path_s']:.2f} s, phase {out['wall_s']:.2f} s ({card})")
    log("mesh record: " + json.dumps(dict(out, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in shapes.items()})))
    return out


# --- the service tier (run_all.py config11_service) -------------------------

class SvcClient:
    """run_all.py config11_service's tenant: a DocSet on the backend
    namespace `be` holding `doc`, over a lossless queue transport and a
    ResilientChannel to its server session."""

    def __init__(self, M, svc, be, tid: str, room_id: str, doc):
        from collections import deque
        am = M.am
        self.svc, self.tid, self.room_id = svc, tid, room_id
        self.to_server, self.to_client = deque(), deque()
        self.ds = am.DocSet(backend=be)
        self.ds.set_doc(room_id, doc)
        svc.connect(tid, room_id, self.to_client.append)
        self.chan = M.res.ResilientChannel(self.to_server.append, None)
        self.conn = am.Connection(self.ds, self.chan.send)
        self.chan._deliver = self.conn.receive_msg
        self.conn.open()

    def pump(self):
        while self.to_server:
            env = self.to_server.popleft()
            sess = self.svc.session(self.tid)
            if sess is not None:
                sess.on_wire(env)
        while self.to_client:
            self.chan.on_wire(self.to_client.popleft())
        self.chan.tick()

    def doc(self):
        return self.ds.get_doc(self.room_id)


def svc_settle(svc, clients, max_ticks: int = 800) -> int:
    """Pump every client and tick until the service and every channel
    are idle; -> the ticks it took."""
    for i in range(max_ticks):
        for c in clients:
            c.pump()
        svc.tick()
        if svc.idle() and all(c.chan.idle and not c.to_server
                              and not c.to_client for c in clients):
            return i + 1
    raise AssertionError(f"service never quiesced: {svc.metrics()}")


def bulk_schedule(n_docs: int, n_rounds: int, ops: int = 8) -> list:
    """16c's bulk-mesh traffic: round r appends an `ops`-op run to four
    new docs and revisits the doc first touched three rounds before (a
    page-in once the pager has demoted it)."""
    seqs, ctrs, out = {}, {}, []
    for r in range(n_rounds):
        picks = [(4 * r + k) % n_docs for k in range(4)]
        if r >= 3:
            picks.append((4 * (r - 3)) % n_docs)
        rnd = {}
        for p in dict.fromkeys(picks):
            d = f"bulk-{p}"
            seqs[d] = seqs.get(d, 0) + 1
            rnd.update(stack_text_round([d], seqs[d], ctrs.get(d, 0) + 1,
                                        ops))
            ctrs[d] = ctrs.get(d, 0) + ops // 2
        out.append(rnd)
    return out


def svc_run(torch, M, card: str, device, label: str, n_sessions: int,
            room_size: int, n_rounds: int, text_chars: int = 0,
            shard_lanes: int = 0, budget_bytes: int = 0, spill_dir=None,
            bulk=None, keep: bool = False) -> tuple:
    """One service run on `device`: run_all.py config11_service's shape.
    `n_sessions` tenants in rooms of `room_size` over lossless queue
    transports into one SyncService (every room, lane and client document
    on `device`), the join handshake settled off the clock, then
    `n_rounds` rounds in which every client edits once and pumps, one
    tick a round, and the settle to quiescence: the timed window.
    `text_chars` 0 is cfg11's document (`t` = Text("svc"), `m` = {}) and
    its edit (one key of `m`); otherwise each room's `t` holds that many
    chars (restored from one checkpoint of the founding document under
    each replica's own actor) and each edit inserts sync-a's 10 chars at
    index 0. `bulk` is a `bulk_schedule` fed to the residency tier's doc
    mesh, one round a tick. Asserts cfg11's checks: admitted ops >=
    sessions x rounds, room-0 converged, zero lag at quiescence.
    Returns (record, {room: save() bytes}[, the service when `keep`])."""
    am = M.am
    be = am.backend.backend_for(device)
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n_rooms = max(1, n_sessions // room_size)
    rooms = [f"room-{g}" for g in range(n_rooms)]
    _pinned_uuids(M)
    t_setup = time.perf_counter()
    svc = M.service.SyncService(M.service.ServiceConfig(
        device=device, shard_lanes=shard_lanes,
        residency_budget_bytes=budget_bytes, residency_spill_dir=spill_dir,
        default_budget=M.service.TenantBudget(
            ops_per_tick=SVC_OPS_PER_TICK, inbox_cap=SVC_INBOX)))
    try:
        if text_chars:
            origin = am.change(
                am.init({"actorId": "room-origin", "backend": be}),
                lambda d: (d.__setitem__("t", am.Text("x" * text_chars)),
                           d.__setitem__("m", {})))
            bundle = am.checkpoint_doc(origin)
            del origin

            def founding(rid, actor):
                return am.frontend.set_actor_id(
                    am.restore(bundle, {"backend": be}), actor)

            def edit(d, r, i):
                d["t"].insert_at(0, *SVC_TEXT_EDIT)
        else:
            bases = {}

            def founding(rid, actor):
                if rid not in bases:
                    doc0 = am.change(
                        am.init({"actorId": f"{rid}-origin", "backend": be}),
                        lambda d: (d.__setitem__("t", am.Text("svc")),
                                   d.__setitem__("m", {})))
                    bases[rid] = am.get_all_changes(doc0)
                return am.apply_changes(
                    am.init({"actorId": actor, "backend": be}), bases[rid])

            def edit(d, r, i):
                d["m"][f"k{i}"] = r
        for g, rid in enumerate(rooms):
            svc.seed_doc(rid, founding(rid, f"server-{g}"))
        clients = [SvcClient(M, svc, be, f"t{i}", rooms[i % n_rooms],
                             founding(rooms[i % n_rooms], f"c-t{i}"))
                   for i in range(n_sessions)]
        join_ticks = svc_settle(svc, clients)
        sync()
        setup_s = time.perf_counter() - t_setup
        ops0 = svc.stats["admitted_ops"]
        before = dict(M.S.launches)
        t0 = time.perf_counter()
        for r in range(n_rounds):
            for i, c in enumerate(clients):
                c.ds.set_doc(c.room_id, am.change(
                    c.doc(), lambda d, r=r, i=i: edit(d, r, i)))
                c.pump()
            if bulk is not None:
                svc.mesh_deliver(bulk[r])
            svc.tick()
        settle_ticks = svc_settle(svc, clients)
        sync()
        window_s = time.perf_counter() - t0
        window = {k: M.S.launches[k] - before.get(k, 0)
                  for k in M.S.launches}
        admitted = svc.stats["admitted_ops"] - ops0
        if admitted < n_sessions * n_rounds:
            raise AssertionError(f"{label}: admitted {admitted} < "
                                 f"{n_sessions * n_rounds}")

        def canon(d):
            return json.dumps(am.to_json(d), sort_keys=True)
        want = canon(svc.room("room-0").doc_set.get_doc("room-0"))
        for c in clients:
            if c.room_id == "room-0" and canon(c.doc()) != want:
                raise AssertionError(f"{label}: room-0 diverged")
        svc.probe_lag()
        m = svc.metrics()
        if m["max_lag_ops"] or m["max_lag_ticks"] or m["lagging_tenants"]:
            raise AssertionError(f"{label}: lag at quiescence: {m}")
        docs = {rid: svc.room(rid).doc_set.get_doc(rid) for rid in rooms}
        if not all(_on_device(M, d, device) for d in docs.values()) or \
                not all(_on_device(M, c.doc(), device) for c in clients):
            raise AssertionError(f"{label}: a document left {device}")
        saves = {rid: am.save(d) for rid, d in docs.items()}
        rec = {"sessions": n_sessions, "rooms": n_rooms,
               "rounds": n_rounds, "text_chars": text_chars,
               "shard_lanes": shard_lanes, "setup_s": setup_s,
               "join_ticks": join_ticks, "window_s": window_s,
               "settle_ticks": settle_ticks, "admitted_ops": admitted,
               "admitted_ops_per_s": admitted / window_s,
               "p50_tick_ms": m["p50_tick_ms"],
               "p99_tick_ms": m["p99_tick_ms"],
               "tick_p99_ms_telemetry": svc.tick_p99_ms_telemetry(),
               "shed_total": m["shed_total"], "evictions": m["evictions"],
               "deferrals": m["deferrals"], "peak_inbox": m["peak_inbox"],
               "peak_parked": m["peak_parked"],
               "peak_lag_ops": m["peak_lag_ops"],
               "max_lag_ops": m["max_lag_ops"], "window_launches": window}
        log(f"{label} ({card}): {n_sessions} sessions in {n_rooms} rooms, "
            f"{n_rounds} rounds: {admitted} ops admitted in "
            f"{window_s:.3f} s ({rec['admitted_ops_per_s']:.1f} ops/s), "
            f"tick p50 {m['p50_tick_ms']} ms, p99 {m['p99_tick_ms']} ms, "
            f"shed {m['shed_total']}, evictions {m['evictions']}, "
            f"deferrals {m['deferrals']}, peak inbox {m['peak_inbox']}; "
            f"set-up {setup_s:.2f} s; kernels in the window {window}")
        out = (rec, saves) + ((svc,) if keep else ())
        if not keep:
            svc.close()
        return out
    except BaseException:
        svc.close()
        raise
    finally:
        M.uuid.reset()


def svc_shard_ref(torch, M, device, n_rooms: int, n_rounds: int,
                  n_lanes: int) -> dict:
    """16c's reference: an unbounded `n_lanes`-lane mesh on `device` fed
    the bulk schedule of `n_rooms` docs over `n_rounds` rounds. It is
    not the service path, so `svc_phase` builds it before it sets the
    kernel counts to 0. -> the schedule, the docs it touches, their
    captures' digests and the largest doc's device bytes."""
    bulk = bulk_schedule(n_rooms, n_rounds)
    touched = sorted({d for rnd in bulk for d in rnd})
    ref = M.shard.ShardedDocSet(n_shards=n_lanes,
                                devices=[torch.device(device or "cuda")],
                                assert_budget=False)
    try:
        for rnd in bulk:
            ref.deliver_round(rnd)
        return {"bulk": bulk, "touched": touched,
                "digests": _mesh_digests(ref, touched),
                "per_doc": max(doc.device_footprint()["device_bytes"]
                               for lane in ref.lanes
                               for doc in lane.docs.values())}
    finally:
        ref.close()


def svc_shard(torch, M, card: str, device, saves_a: dict, ref: dict,
              n_sessions: int, room_size: int, n_rounds: int, n_lanes: int,
              budget_rooms: int) -> dict:
    """16c: 16a's population on `n_lanes` lanes (streams of the card)
    with the residency tier on at a budget of `budget_rooms` docs' bytes
    of the bulk mesh (its per-doc bytes from `ref`, the unbounded
    reference mesh `svc_shard_ref` fed the same `bulk_schedule`), once
    with the sequential tick and once with AMTPU_TICK_PIPELINE=1. Each
    room's save() must equal 16a's, the bulk mesh's captures the
    reference's, and the pager must hold its budget."""
    import tempfile
    bulk, touched, per_doc = ref["bulk"], ref["touched"], ref["per_doc"]
    budget = budget_rooms * per_doc
    out = {"lanes": n_lanes, "bulk_docs": len(touched),
           "per_doc_bytes": per_doc, "budget_bytes": budget}
    prior = os.environ.get("AMTPU_TICK_PIPELINE")
    try:
        for leg, flag in (("sequential", "0"), ("pipelined", "1")):
            os.environ["AMTPU_TICK_PIPELINE"] = flag
            M.dt.REGISTRY.clear_session()
            with tempfile.TemporaryDirectory() as spill:
                rec, saves, svc = svc_run(
                    torch, M, card, device, f"16c svc-shard {leg}",
                    n_sessions, room_size, n_rounds, shard_lanes=n_lanes,
                    budget_bytes=budget, spill_dir=spill, bulk=bulk,
                    keep=True)
                try:
                    if saves != saves_a:
                        raise AssertionError(f"16c {leg}: room saves "
                                             "differ from 16a's")
                    mesh, res = svc.doc_mesh, svc.residency
                    _sync_lanes(torch, mesh)
                    _check_lane_tables(mesh)
                    if _mesh_digests(mesh, touched) != ref["digests"]:
                        raise AssertionError(f"16c {leg}: bulk captures "
                                             "differ from the reference")
                    m = res.metrics()
                    peak = res.peak_resident_bytes
                    if m["budget_overruns"] or peak > budget or not (
                            m["page_outs"] and m["page_ins"]):
                        raise AssertionError(f"16c {leg}: pager {m}, peak "
                                             f"{peak} of {budget}")
                    ex = svc._mesh_executor()
                    fanned = ex is not None and ex.stats["barriers"] > 0
                    if fanned != (flag == "1"):
                        raise AssertionError(f"16c {leg}: the tick "
                                             f"executor fanned out: {fanned}")
                    smap = svc.shard_map()
                    used = sum(1 for ln in smap["lanes"].values()
                               if ln["rooms"])
                    if smap["n_lanes"] != n_lanes or used < 2:
                        raise AssertionError(f"16c {leg}: shard map {smap}")
                    rdesc = svc.describe()["residency"]
                    # plain JSON (no default=): devices are written as names
                    log(f"16c {leg} shard_map: {json.dumps(smap)}")
                    log(f"16c {leg} residency: {json.dumps(rdesc)}")
                    out[leg] = dict(rec, peak_resident_bytes=peak,
                                    pager=dict(m),
                                    executor=(dict(ex.stats)
                                              if ex is not None else None))
                finally:
                    svc.close()
    finally:
        if prior is None:
            os.environ.pop("AMTPU_TICK_PIPELINE", None)
        else:
            os.environ["AMTPU_TICK_PIPELINE"] = prior
    return out


def svc_scrape(M, svc, clients_room: str = "room-0") -> dict:
    """16d: the loopback scrape endpoint against 16b's live service with
    lineage sampling on: one more edit of the room's server replica
    flushed through a tick, then GET /metrics (validate_prom-clean) and
    GET /describe (JSON holding the lineage and learned_index blocks)."""
    import urllib.request
    am = M.am
    led = M.lineage.enable(rate=1, capacity=4096)
    try:
        ds = svc.room(clients_room).doc_set
        ds.set_doc(clients_room, am.change(
            ds.get_doc(clients_room),
            lambda d: d["t"].insert_at(0, *SVC_TEXT_EDIT)))
        svc.tick()
        srv = svc.serve_metrics()
        try:
            if srv.host != "127.0.0.1":
                raise AssertionError(f"16d: bound {srv.host}")
            t = time.perf_counter()
            page = urllib.request.urlopen(srv.url + "/metrics",
                                          timeout=60).read().decode()
            metrics_s = time.perf_counter() - t
            counts = M.prom.validate_prom(page)
            t = time.perf_counter()
            dump = json.loads(urllib.request.urlopen(
                srv.url + "/describe", timeout=60).read())
            describe_s = time.perf_counter() - t
        finally:
            srv.close()
        if "lineage" not in dump or not dump["lineage"]["chains"]:
            raise AssertionError("16d: /describe has no lineage chains")
        if dump["learned_index"]["schema"] != "amtpu-learned-index-v1":
            raise AssertionError("16d: /describe has no learned_index")
        for fam in ("amtpu_svc_admitted_ops_total", "amtpu_lineage_",
                    "amtpu_index_lookups_total", "amtpu_device_"):
            if fam not in page:
                raise AssertionError(f"16d: /metrics lacks {fam}")
        out = {"families": counts["families"], "samples": counts["samples"],
               "metrics_bytes": len(page), "metrics_s": metrics_s,
               "describe_s": describe_s,
               "lineage_chains": dump["lineage"]["chains"],
               "learned_index_sites": sorted(dump["learned_index"]["sites"]),
               "demoted_sites": dump["learned_index"]["demoted_sites"]}
        log(f"16d scrape: /metrics {counts['families']} families, "
            f"{counts['samples']} samples ({len(page)} bytes, "
            f"{metrics_s * 1e3:.1f} ms); /describe {describe_s * 1e3:.1f} "
            f"ms with {out['lineage_chains']} lineage chains and the "
            f"learned_index block ({out['learned_index_sites']})")
        return out
    finally:
        led.clear()
        M.lineage.disable()


def svc_phase(torch, M, card: str, device=None,
              n_sessions: int = SVC_SESSIONS, room_size: int = SVC_ROOM,
              n_rounds: int = SVC_ROUNDS, text_rooms: int = SVC_TEXT_ROOMS,
              text_chars: int = API_TEXT, n_lanes: int = SVC_LANES,
              budget_rooms: int = SVC_RES_ROOMS, twins=None) -> dict:
    """The service tier on `device`: 16a svc-a (cfg11 at its defaults),
    16b svc-text (the same service on rooms of cfg7's text; multi_scan
    must launch in its timed window), 16c svc-shard (16a on lanes with
    the pager, sequential and pipelined ticks), 16d the scrape endpoint.
    On the card 16a and 16b also run on the CPU in `twins`' worker (a
    CpuTwins) while the card's parts go on, and the card's room saves
    must equal theirs. The kernel counts are set to 0 after 16c's
    reference mesh is built (it is not the service path) and read after
    the card's parts. Raises on any failed check."""
    cuda = torch.device(device or "cuda").type == "cuda"
    if cuda:
        wants = [twins.submit("svc_run", "cpu backend", "cpu", "16a svc-a",
                              n_sessions, room_size, n_rounds, item=1),
                 twins.submit("svc_run", "cpu backend", "cpu",
                              "16b svc-text", text_rooms * room_size,
                              room_size, n_rounds, text_chars=text_chars,
                              item=1)]
    t_phase = time.perf_counter()
    ref = svc_shard_ref(torch, M, device, max(1, n_sessions // room_size),
                        n_rounds, n_lanes)
    if cuda:
        torch.cuda.synchronize()
    M.S.reset_launches()
    a, saves_a = svc_run(torch, M, card, device, "16a svc-a", n_sessions,
                         room_size, n_rounds)
    b, saves_b, svc_b = svc_run(torch, M, card, device, "16b svc-text",
                                text_rooms * room_size, room_size,
                                n_rounds, text_chars=text_chars, keep=True)
    try:
        if cuda and not b["window_launches"]["multi_scan"]:
            raise AssertionError("16b: multi_scan did not launch in the "
                                 f"timed window: {b['window_launches']}")
        c = svc_shard(torch, M, card, device, saves_a, ref, n_sessions,
                      room_size, n_rounds, n_lanes, budget_rooms)
        d = svc_scrape(M, svc_b)
    finally:
        svc_b.close()
        del svc_b
    if cuda:
        torch.cuda.synchronize()
    launches = dict(M.S.launches)
    shapes = {k: dict(v) for k, v in M.S.launch_shapes.items()}
    card_s = time.perf_counter() - t_phase
    if cuda:
        t = time.perf_counter()
        want_a, want_b = (w.result() for w in wants)
        wait_s = time.perf_counter() - t
        for part, got, want in (("16a", saves_a, want_a),
                                ("16b", saves_b, want_b)):
            if got != want:
                raise AssertionError(f"{part}: the card's room saves differ "
                                     "from the CPU run's")
        if not launches["multi_scan"]:
            raise AssertionError(f"service: multi_scan missed the service "
                                 f"path: {launches}")
    else:
        wait_s = 0.0
    out = {"a": a, "b": b, "c": c, "d": d, "launches": launches,
           "shapes": shapes, "card_s": card_s, "cpu_wait_s": wait_s,
           "wall_s": time.perf_counter() - t_phase}
    log(f"service phase launches: {launches}; card parts {card_s:.2f} s, "
        f"then {wait_s:.2f} s waiting for the CPU runs; room saves equal to "
        f"the CPU run's ({card})")
    log("svc record: " + json.dumps(dict(out, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in shapes.items()}), default=str))
    return out


# --- scripts/soak.py's helpers, shared by phases 17 and 19 -------------------

KEYS = ["alpha", "beta", "gamma", "delta", "eps"]


def _rand_value(rng):
    """scripts/soak.py `_rand_value`: an int, a 5-letter string, a map or
    a list, drawn from `rng`."""
    kind = rng.integers(0, 4)
    if kind == 0:
        return int(rng.integers(-1000, 1000))
    if kind == 1:
        return "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 5))
    if kind == 2:
        return {"n": int(rng.integers(0, 99))}
    return [int(x) for x in rng.integers(0, 9, 3)]


def _text_edit(am, doc, rng):
    """scripts/soak.py `_text_edit`: one random insert or delete in `t`."""
    def cb(d):
        t = d["t"]
        n = len(t)
        if n and rng.integers(0, 3) == 0:
            t.delete_at(int(rng.integers(0, n)))
        else:
            t.insert_at(int(rng.integers(0, n + 1)),
                        chr(97 + int(rng.integers(0, 26))))
    return am.change(doc, cb)


def _converged(am, docs):
    """scripts/soak.py `_converged`: (True, None) when every document
    renders as the first does, else (False, (first, differing))."""
    jsons = [am.to_json(d) for d in docs]
    ref = {k: (str(v) if hasattr(v, "elems") else v)
           for k, v in jsons[0].items()}
    for j in jsons[1:]:
        got = {k: (str(v) if hasattr(v, "elems") else v)
               for k, v in j.items()}
        if got != ref:
            return False, (ref, got)
    return True, None


# --- the federation (scripts/soak.py session_federation) -----------------

def fed_phase(torch, M, card: str, device=None, seed: int = 0,
              n_rooms: int = FED_ROOMS, n_sessions: int = FED_SESSIONS,
              n_ticks: int = FED_TICKS, quiesce_rounds: int = 6000,
              twins=None) -> dict:
    """Phase 17: scripts/soak.py session_federation at its defaults on
    `device` — three FederatedRegions (each a SyncService whose rooms
    live on `device`) over seeded cross_region WAN chaos, `n_sessions`
    write sessions over `n_ticks` ticks while us-eu and eu-ap partition
    and heal and region ap is killed and rejoins empty. Asserts the
    soak's three checks: byte-identical convergence on every region
    (canonical saves and sorted histories), zero residual lag with every
    link on `ok`, full reclamation. On the card the phase also runs on
    the CPU in `twins`' worker (a CpuTwins) while the card's run goes
    on, and the card's canonical saves must equal its. The kernel counts
    are set to 0 before the phase and read after the card's run."""
    am = M.am
    be = am.backend.backend_for(device)
    cuda = torch.device(device or "cuda").type == "cuda"
    if cuda:
        want_run = twins.submit("fed_phase", "cpu backend", "cpu", seed,
                                n_rooms, n_sessions, n_ticks,
                                quiesce_rounds)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    F = M.federation
    sync()
    M.S.reset_launches()
    _pinned_uuids(M)
    rng = np.random.default_rng(seed)
    names = ["us", "eu", "ap"]
    placement = F.RegionPlacement(names)
    t_phase = time.perf_counter()

    def mk_region(name):
        return F.FederatedRegion(
            M.service.SyncService(M.service.ServiceConfig(
                region=name, device=device)), name,
            placement=placement, probe_every=2, max_buffer=256,
            max_retries=4)

    regions = {n: mk_region(n) for n in names}
    chaos = {}
    s = seed * 7919 + 1
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            a, b = names[i], names[j]
            _, _, fwd, rev = F.connect_regions(
                regions[a], regions[b], profile="cross_region", seed=s)
            chaos[(a, b)] = (fwd, rev)
            s += 10
    room_ids = [f"room-{g}" for g in range(n_rooms)]
    for room_id in room_ids:
        doc0 = am.change(
            am.init({"actorId": f"{room_id}-origin", "backend": be}),
            lambda d: (d.__setitem__("t", am.Text("start")),
                       d.__setitem__("m", {})))
        base = am.get_all_changes(doc0)
        for r in regions.values():
            r.svc.seed_doc(room_id, am.apply_changes(
                am.init({"actorId": f"srv-{r.name}-{room_id}",
                         "backend": be}), base))
            r.svc.room(room_id).hub.snapshot_min_changes = 8

    def pump_all(rounds=1):
        for _ in range(rounds):
            for r in regions.values():
                r.pump()
                r.svc.tick()

    def edit(region_name, room_id):
        ds = regions[region_name].svc.room(room_id).doc_set
        doc = ds.get_doc(room_id)
        if doc is None:
            return False
        if int(rng.integers(0, 3)) == 0:
            doc = _text_edit(am, doc, rng)
        else:
            k = KEYS[int(rng.integers(0, len(KEYS)))]
            doc = am.change(doc, lambda d, k=k,
                            v=int(rng.integers(0, 999)):
                            d["m"].__setitem__(k, v))
        ds.set_doc(room_id, doc)
        return True

    cut_a = ("us", "eu")
    cut_a_at, cut_a_len = n_ticks // 5, max(4, n_ticks // 6)
    cut_b = ("eu", "ap")
    cut_b_at, cut_b_len = (2 * n_ticks) // 3, max(4, n_ticks // 8)
    kill_name = "ap"
    kill_at = n_ticks // 2
    rejoin_at = kill_at + max(4, n_ticks // 8)
    killed = False
    n_writes = n_skipped = 0
    per_tick = max(1, n_sessions // n_ticks)

    def kill_edges(name):
        for (a, b), (f, r) in chaos.items():
            if name in (a, b):
                f.partition()
                r.partition()

    def rejoin_region(name):
        fresh = mk_region(name)
        ls = seed * 104729 + 17
        for (a, b), (f, r) in chaos.items():
            if b == name:
                ln = fresh.link_to(a, seed=ls)
                f._deliver = ln.on_raw
                ln.attach_transport(r)
            elif a == name:
                ln = fresh.link_to(b, seed=ls)
                r._deliver = ln.on_raw
                ln.attach_transport(f)
            else:
                continue
            ls += 3
            f.heal()
            r.heal()
        regions[name] = fresh

    try:
        t0 = time.perf_counter()
        for t in range(n_ticks):
            if t == cut_a_at:
                f, r = chaos[cut_a]
                f.partition()
                r.partition()
            if t == cut_a_at + cut_a_len and not killed:
                f, r = chaos[cut_a]
                f.heal()
                r.heal()
            if t == cut_b_at:
                f, r = chaos[cut_b]
                f.partition()
                r.partition()
            if t == cut_b_at + cut_b_len:
                f, r = chaos[cut_b]
                f.heal()
                r.heal()
            if t == kill_at:
                killed = True
                regions.pop(kill_name)
                kill_edges(kill_name)
            if t == rejoin_at:
                killed = False
                rejoin_region(kill_name)
            for _ in range(per_tick):
                room_id = room_ids[int(rng.integers(0, n_rooms))]
                if int(rng.integers(0, 5)) == 0:
                    target = list(regions)[int(rng.integers(
                        0, len(regions)))]
                else:
                    target = placement.home(room_id)
                    if target not in regions:
                        target = next(iter(regions))
                if edit(target, room_id):
                    n_writes += 1
                else:
                    n_skipped += 1
            pump_all()
        sync()
        write_s = time.perf_counter() - t0
        if killed:
            rejoin_region(kill_name)
        for f, r in chaos.values():
            f.heal()
            r.heal()
        t1 = time.perf_counter()
        for q in range(quiesce_rounds):
            pump_all()
            if q > 5 and all(r.idle() for r in regions.values()):
                break
        else:
            raise AssertionError(
                "17: never quiesced: "
                f"{ {n: r.lag_table() for n, r in regions.items()} }")
        sync()
        quiesce_s = time.perf_counter() - t1
        quiesce_n = q + 1
        canon_saves = {}
        for room_id in room_ids:
            docs = {n: r.svc.room(room_id).doc_set.get_doc(room_id)
                    for n, r in regions.items()}
            if any(d is None for d in docs.values()):
                raise AssertionError(f"17 {room_id}: a missing replica")
            if not all(_on_device(M, d, device) for d in docs.values()):
                raise AssertionError(f"17 {room_id}: a replica left "
                                     f"{device}")
            saves, hists = {}, {}
            for n, d in docs.items():
                chs = sorted(am.get_all_changes(d),
                             key=lambda c: (c["actor"], c["seq"]))
                saves[n] = am.save(am.apply_changes(
                    am.init({"actorId": "canon-probe", "backend": be}),
                    chs))
                hists[n] = sorted(json.dumps(c, sort_keys=True)
                                  for c in chs)
            if len(set(saves.values())) != 1:
                raise AssertionError(f"17 {room_id}: saves diverged")
            ref = next(iter(hists.values()))
            if not all(h == ref for h in hists.values()):
                raise AssertionError(f"17 {room_id}: histories diverged")
            canon_saves[room_id] = _digest(
                next(iter(saves.values())).encode())
        residual = {(n, peer): entry for n, r in regions.items()
                    for peer, entry in r.lag_table().items()
                    if entry["lag_tokens"] or entry["state"] != "ok"}
        if residual:
            raise AssertionError(f"17: residual lag {residual}")
        for n, r in regions.items():
            for room_id in room_ids:
                if r.svc.room(room_id).gate._n_parked:
                    raise AssertionError(f"17: {n}/{room_id} quarantine "
                                         "not drained")
            for peer, link in r.links.items():
                if link._buf_adverts or link._buf_data or \
                        link.chan._recv_buf:
                    raise AssertionError(f"17: {n}->{peer} buffers not "
                                         "drained")
    except BaseException:
        try:
            out_dir = os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "chiprun_out")
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, "federation_postmortem.json")
            with open(path, "w") as fh:
                json.dump({n: r.svc.describe() for n, r in regions.items()},
                          fh, indent=1, default=str)
            log(f"17: federation postmortem written to {path}")
        except Exception as dump_exc:   # noqa: BLE001 - never mask
            log(f"17: postmortem dump failed: {dump_exc!r}")
        raise
    finally:
        M.uuid.reset()
    sync()
    launches = dict(M.S.launches)
    shapes = {k: dict(v) for k, v in M.S.launch_shapes.items()}
    links = [ln for r in regions.values() for ln in r.links.values()]
    out = {"regions": len(regions), "rooms": n_rooms,
           "sessions": n_sessions, "ticks": n_ticks, "writes": n_writes,
           "writes_skipped_bootstrapping": n_skipped,
           "write_s": write_s, "quiesce_s": quiesce_s,
           "quiesce_rounds": quiesce_n,
           "writes_per_s": n_writes / write_s,
           "reconnects": sum(ln.stats["reconnects"] for ln in links),
           "channel_revives": sum(ln.chan.stats["revives"] for ln in links),
           "buffer_dropped": sum(ln.stats["buffer_dropped"] for ln in links),
           "shipped": sum(ln.stats["shipped"] for ln in links),
           "delivered": sum(ln.stats["delivered"] for ln in links),
           "group_tokens_minted": sum(r.clock.stats["minted"]
                                      for r in regions.values()),
           "ladder_transitions": {
               k: sum(ln.transitions.get(k, 0) for ln in links)
               for k in sorted({t for ln in links for t in ln.transitions})},
           "canonical_save_sha256": canon_saves,
           "launches": launches, "shapes": shapes,
           "wall_s": time.perf_counter() - t_phase}
    if cuda and not launches["multi_scan"]:
        raise AssertionError(f"17: multi_scan missed the federation path: "
                             f"{launches}")
    log(f"17 federation ({card}): 3 regions, {n_rooms} rooms, {n_writes} "
        f"writes over {n_ticks} ticks in {write_s:.2f} s "
        f"({out['writes_per_s']:.1f} writes/s; {n_skipped} skipped while "
        f"bootstrapping), quiesced in {quiesce_n} rounds ({quiesce_s:.2f} "
        f"s); {out['reconnects']} reconnects, {out['buffer_dropped']} "
        f"buffered drops; converged byte-identically with zero residual "
        f"lag; launches {launches}")
    if cuda:
        # the schedule is seeded and no clock enters it, and the worker
        # iterates sets in this process's string-hash order (both run
        # with PYTHONHASHSEED=0), so the same run on the plain versions
        # must reach the same documents
        want = want_run.result()
        out["cpu_s"] = want["wall_s"]
        if want["canonical_save_sha256"] != canon_saves:
            raise AssertionError("17: the card's canonical saves differ "
                                 "from the CPU run's")
        sched = ("writes", "writes_skipped_bootstrapping", "quiesce_rounds",
                 "reconnects", "shipped", "delivered", "group_tokens_minted")
        out["cpu_schedule_equal"] = all(out[k] == want[k] for k in sched)
        log(f"17: canonical saves equal to the CPU run's ({card}; CPU run "
            f"{out['cpu_s']:.2f} s); schedule counters equal: "
            f"{out['cpu_schedule_equal']}")
    log("fed record: " + json.dumps(dict(out, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in shapes.items()})))
    return out


# --- the JAX package's remaining workloads (benchmarks/run_all.py cfg5b,
# cfg5c, cfg6, cfg2, cfg10, cfg7b) -------------------------------------------

def residual_heavy_batch(TB, C, n_actors: int):
    """A copy of run_all.py config5b_residual_heavy's batch (:987-1030):
    n_actors changes of 1,000 ops on a base of 100 * n_actors chars, 20%
    of them residuals: 400 ins/set pairs typed after the actor's own base
    element, 100 bare deletes of its distinct base range, 100 value-less
    inserts. Returns (batch, base_n, the visible count the config
    asserts)."""
    base_n = 100 * n_actors
    run_pairs, n_del, n_bare = 400, 100, 100
    n_per = 2 * run_pairs + n_del + n_bare
    n_ops = n_actors * n_per
    actors = [f"actor-{i:06d}" for i in range(n_actors)]
    op_change = np.repeat(np.arange(n_actors, dtype=np.int32), n_per)
    kind = np.empty(n_ops, np.int8)
    ta = np.zeros(n_ops, np.int32)
    tc = np.zeros(n_ops, np.int32)
    pa = np.zeros(n_ops, np.int32)
    pc = np.zeros(n_ops, np.int32)
    val = np.zeros(n_ops, np.int64)
    pair_kind = np.tile(np.array([C.KIND_INS, C.KIND_SET], np.int8),
                        run_pairs)
    ctrs = np.arange(1, run_pairs + 1, dtype=np.int32) + base_n + 1
    for a in range(n_actors):
        s = a * n_per
        e_run = s + 2 * run_pairs
        kind[s:e_run] = pair_kind
        ta[s:e_run] = a
        tc[s: e_run: 2] = ctrs
        tc[s + 1: e_run: 2] = ctrs
        pa[s] = n_actors                      # 'base' rank
        pc[s] = a * 100 + 1
        pa[s + 2: e_run: 2] = a
        pc[s + 2: e_run: 2] = ctrs[:-1]
        val[s + 1: e_run: 2] = 97 + (a % 26)
        d0 = e_run
        kind[d0: d0 + n_del] = C.KIND_DEL
        ta[d0: d0 + n_del] = n_actors
        tc[d0: d0 + n_del] = a * 100 + 1 + np.arange(n_del)
        b0 = d0 + n_del
        kind[b0: b0 + n_bare] = C.KIND_INS
        ta[b0: b0 + n_bare] = a
        tc[b0: b0 + n_bare] = ctrs[-1] + 1 + np.arange(n_bare)
        pa[b0: b0 + n_bare] = n_actors
        pc[b0: b0 + n_bare] = a * 100 + 50
    batch = TB(
        obj_id="t", actors=actors, seqs=np.ones(n_actors, np.int32),
        deps=[{"base": 1}] * n_actors, messages=[None] * n_actors,
        op_change=op_change, op_kind=kind, op_target_actor=ta,
        op_target_ctr=tc, op_parent_actor=pa, op_parent_ctr=pc,
        op_value=val, actor_table=actors + ["base"], value_pool=[])
    return batch, base_n, base_n - n_actors * n_del + n_actors * run_pairs


def residual_heavy_text(n_actors: int) -> str:
    """Independent reference of the cfg5b merge: every base char is
    deleted, each actor's run hangs alone off its own base element and
    the bare inserts carry no value, so the text is the runs in actor
    order."""
    return "".join(chr(97 + a % 26) * 400 for a in range(n_actors))


def two_round_targets(n_actors: int, base_n: int):
    return np.random.default_rng(7).integers(1, base_n, n_actors)


def two_round_batch(TB, C, n_actors: int, base_n: int):
    """A copy of run_all.py config5c_two_causal_rounds's batch
    (:1262-1305): every actor delivers two causally chained changes of
    250 ins/set pairs (seq 2 continues its own seq-1 run), the seq-1 runs
    after rng(7) targets of the base."""
    pairs_per_change = 250
    n_changes = 2 * n_actors
    n_per = 2 * pairs_per_change
    n_ops = n_changes * n_per
    actors = [f"actor-{i:06d}" for i in range(n_actors)]
    op_change = np.repeat(np.arange(n_changes, dtype=np.int32), n_per)
    kind = np.tile(np.array([C.KIND_INS, C.KIND_SET], np.int8),
                   n_changes * pairs_per_change)
    ta = np.repeat(np.arange(n_actors, dtype=np.int32), 2 * n_per)
    tc = np.zeros(n_ops, np.int32)
    pa = np.zeros(n_ops, np.int32)
    pc = np.zeros(n_ops, np.int32)
    val = np.zeros(n_ops, np.int64)
    targets = two_round_targets(n_actors, base_n)
    c1 = np.arange(1, pairs_per_change + 1, dtype=np.int32) + base_n + 1
    c2 = c1 + pairs_per_change
    for a in range(n_actors):
        for half, ctrs in ((0, c1), (1, c2)):
            s = (2 * a + half) * n_per
            tc[s: s + n_per: 2] = ctrs
            tc[s + 1: s + n_per: 2] = ctrs
            if half == 0:
                pa[s] = n_actors
                pc[s] = int(targets[a])
            else:
                pa[s] = a                 # continue own seq-1 run
                pc[s] = c1[-1]
            pa[s + 2: s + n_per: 2] = a
            pc[s + 2: s + n_per: 2] = ctrs[:-1]
            val[s + 1: s + n_per: 2] = 97 + (a % 26)
    seqs = np.empty(n_changes, np.int32)
    seqs[0::2] = 1
    seqs[1::2] = 2
    shared = {"base": 1}
    return TB(
        obj_id="t", actors=[a for a in actors for _ in range(2)],
        seqs=seqs, deps=[shared] * n_changes,
        messages=[None] * n_changes, op_change=op_change, op_kind=kind,
        op_target_actor=ta, op_target_ctr=tc, op_parent_actor=pa,
        op_parent_ctr=pc, op_value=val, actor_table=actors + ["base"],
        value_pool=[])


def two_round_text(n_actors: int, base_n: int) -> str:
    """Independent reference of the cfg5c merge: an actor's two changes
    read as one 500-char run after its target; the runs after one target
    share a head counter, so RGA orders them by descending actor id."""
    by_target: dict = {}
    for a, t in enumerate(two_round_targets(n_actors, base_n).tolist()):
        by_target.setdefault(t, []).append(a)
    parts = []
    for i in range(1, base_n + 1):
        parts.append(chr(97 + i % 26))
        for a in reversed(by_target.get(i, ())):
            parts.append(chr(97 + a % 26) * 500)
    return "".join(parts)


def conflict_changes(n_actors: int, n_targets: int):
    """A copy of run_all.py config6_conflict_heavy's changes (:249-268):
    a base of n_targets typed chars, then n_actors concurrent changes
    each overwriting every base char (every fifth, by (actor + index), a
    delete instead). Returns (base change, changes)."""
    base_ops = []
    for i in range(1, n_targets + 1):
        key = "_head" if i == 1 else f"base:{i - 1}"
        base_ops.append({"action": "ins", "obj": "t", "key": key, "elem": i})
        base_ops.append({"action": "set", "obj": "t", "key": f"base:{i}",
                         "value": chr(97 + i % 26)})
    base = {"actor": "base", "seq": 1, "deps": {}, "ops": base_ops}
    changes = []
    for a in range(n_actors):
        ops = []
        for i in range(1, n_targets + 1):
            if (a + i) % 5 == 0:
                ops.append({"action": "del", "obj": "t",
                            "key": f"base:{i}"})
            else:
                ops.append({"action": "set", "obj": "t", "key": f"base:{i}",
                            "value": chr(65 + (a + i) % 26)})
        changes.append({"actor": f"actor-{a:04d}", "seq": 1,
                        "deps": {"base": 1}, "ops": ops})
    return base, changes


def counter_changes(n_actors: int, n_keys: int):
    """A copy of run_all.py config2_map_counter's changes (:56-65): a
    counter `count` made by `base`, then n_actors concurrent changes each
    setting n_keys own keys and incrementing the counter. Returns (base
    change, changes)."""
    base = {"actor": "base", "seq": 1, "deps": {}, "ops":
            [{"action": "set", "obj": "m", "key": "count", "value": 0,
              "datatype": "counter"}]}
    changes = []
    for a in range(n_actors):
        ops = [{"action": "set", "obj": "m", "key": f"k{a}-{i}", "value": i}
               for i in range(n_keys)]
        ops.append({"action": "inc", "obj": "m", "key": "count", "value": 1})
        changes.append({"actor": f"actor-{a:04d}", "seq": 1,
                        "deps": {"base": 1}, "ops": ops})
    return base, changes


def _spread(values) -> dict:
    return {"median": float(np.median(values)), "min": float(min(values)),
            "max": float(max(values))}


def _label_n(M, kind: str, label: str) -> dict:
    agg = M.accounting.LABELS[kind].get(label, {})
    return {"n": agg.get("n", 0), "ns": agg.get("ns", 0)}


def adv_commit(torch, M, device, batch, base_n: int) -> dict:
    """One run of run_all.py merge_once's discipline (bench.py run_once):
    a fresh document holding the base text with the batch prepared,
    untimed; timed: commit_prepared + the codes-only materialize + the one
    scalar sync. Counts the mixed rounds and slow_info fetches it ran."""
    sync = _sync_of(torch, device)
    doc = M.DeviceTextDoc("t", device=device)
    doc.eager_materialize = True
    doc.apply_batch(base_batch(M.TB, M.C, "t", base_n))
    doc.text()
    prepared = doc.prepare_batch(batch)
    n_rounds = len(prepared.rounds)
    mixed0 = _label_n(M, "dispatch", "fused_mixed_round")
    fetch0 = _label_n(M, "sync", "slow_info_fetch")
    sync()
    with M.accounting.track() as tr:
        t0 = time.perf_counter()
        doc.commit_prepared(prepared)
        doc._materialize(with_pos=False)
        scal = doc._scalars()
        dt = time.perf_counter() - t0
    mixed1 = _label_n(M, "dispatch", "fused_mixed_round")
    fetch1 = _label_n(M, "sync", "slow_info_fetch")
    return {"doc": doc, "commit_s": dt, "n_vis": int(scal[0]),
            "rounds": n_rounds,
            "mixed_rounds": mixed1["n"] - mixed0["n"],
            "slow_fetches": fetch1["n"] - fetch0["n"],
            "slow_fetch_s": (fetch1["ns"] - fetch0["ns"]) / 1e9,
            "d2h_bytes": tr.stats["d2h_bytes"],
            "syncs": tr.stats["syncs"], "dispatches": tr.stats["dispatches"]}


def adv_merge(torch, M, card: str, device, label: str, batch, base_n: int,
              expect_vis: int, want_text: str, reps: int) -> dict:
    """18a / 18b: one warm-up run, under obs.tracing() so the slow_info
    fetch records its seconds, then `reps` timed runs (`adv_commit`); the
    last run's text against the host-computed reference, then the same
    batch once on the CPU, whose text must be equal."""
    n_ops = len(batch.op_kind)
    with M.obs.tracing():
        warm = adv_commit(torch, M, device, batch, base_n)
    del warm["doc"]
    runs = []
    for _ in range(reps):
        run = adv_commit(torch, M, device, batch, base_n)
        doc = run.pop("doc")
        runs.append(run)
    for run in [warm] + runs:
        if run["n_vis"] != expect_vis:
            raise AssertionError(f"{label}: n_vis {run['n_vis']} != "
                                 f"{expect_vis}")
    t = time.perf_counter()
    text = doc.text()
    pull_s = time.perf_counter() - t
    del doc
    if len(text) != expect_vis or text != want_text:
        raise AssertionError(f"{label}: the text differs from the "
                             "host-computed reference")
    times = [r["commit_s"] for r in runs]
    out = {"ops": n_ops, "base": base_n, "reps": reps, "commit_s": times,
           "commit_s_spread": _spread(times),
           "ops_per_s": _spread([n_ops / s for s in times]),
           "rounds": runs[-1]["rounds"], "mixed_rounds": runs[-1][
               "mixed_rounds"], "slow_fetches": runs[-1]["slow_fetches"],
           "slow_fetch_d2h_bytes": runs[-1]["d2h_bytes"],
           "warmup_slow_fetch_s": warm["slow_fetch_s"],
           "syncs": runs[-1]["syncs"], "dispatches": runs[-1]["dispatches"],
           "text_pull_s": pull_s, "text_sha256": sha(text)}
    if torch.device(device or "cuda").type == "cuda":
        t = time.perf_counter()
        cpu = adv_commit(torch, M, "cpu", batch, base_n)
        cpu_text = cpu.pop("doc").text()
        out["cpu_s"] = time.perf_counter() - t
        out["cpu_commit_s"] = cpu["commit_s"]
        if cpu_text != text:
            raise AssertionError(f"{label}: the card's text differs from "
                                 "the CPU run's")
    log(f"{label} ({card}): {n_ops} ops on a {base_n}-char base, "
        f"{out['rounds']} planned rounds, {out['mixed_rounds']} mixed "
        f"rounds; commit+sync median {out['commit_s_spread']['median']:.4f}"
        f" s (range {out['commit_s_spread']['min']:.4f}-"
        f"{out['commit_s_spread']['max']:.4f}), ops/s median "
        f"{out['ops_per_s']['median']:.0f}; slow_info fetches "
        f"{out['slow_fetches']} ({out['slow_fetch_d2h_bytes']} d2h bytes, "
        f"warm-up fetch {out['warmup_slow_fetch_s']:.6f} s); text "
        f"{len(text)} chars equal to the reference"
        + (f" and the CPU run ({out['cpu_s']:.2f} s)" if "cpu_s" in out
           else ""))
    return out


def conflict_run(torch, M, device, base, batch):
    """run_all.py config6's run: the base applied, then timed apply_batch
    + text()."""
    sync = _sync_of(torch, device)
    doc = M.DeviceTextDoc("t", device=device)
    doc.apply_changes([base])
    sync()
    t0 = time.perf_counter()
    doc.apply_batch(batch)
    text = doc.text()
    return doc, text, time.perf_counter() - t0


def adv_conflicts(torch, M, card: str, device, n_actors: int,
                  n_targets: int, reps: int) -> dict:
    """18c, cfg6: every actor overwrites or deletes the same base chars
    (multi-writer registers, the host slow path); the text and conflicts
    against a CPU run of the same batch."""
    base, changes = conflict_changes(n_actors, n_targets)
    batch = M.TB.from_changes(changes, "t")
    n_ops = len(batch.op_kind)
    conflict_run(torch, M, device, base, batch)            # warm-up
    times = []
    for _ in range(reps):
        doc, text, dt = conflict_run(torch, M, device, base, batch)
        times.append(dt)
    cpu_doc, cpu_text, cpu_s = conflict_run(torch, M, "cpu", base, batch)
    if not doc.conflicts:
        raise AssertionError("18c: the conflict-heavy batch minted no "
                             "conflicts")
    if text != cpu_text or doc.conflicts != cpu_doc.conflicts:
        raise AssertionError("18c: the text or the conflicts differ from "
                             "the CPU run's")
    out = {"ops": n_ops, "reps": reps, "apply_s": times,
           "ops_per_s": _spread([n_ops / s for s in times]),
           "conflicts": len(doc.conflicts), "text_len": len(text),
           "cpu_s": cpu_s}
    log(f"18c cfg6 conflict-heavy ({card}): {n_actors} actors x "
        f"{n_targets} targets, {n_ops} ops; ops/s median "
        f"{out['ops_per_s']['median']:.0f} (range "
        f"{out['ops_per_s']['min']:.0f}-{out['ops_per_s']['max']:.0f}); "
        f"{out['conflicts']} conflicted slots, text {len(text)} chars; "
        f"text and conflicts equal to the CPU run's ({cpu_s:.3f} s)")
    return out


def counter_run(torch, M, device, base, batch):
    """run_all.py config2's run: the base counter, then timed
    apply_batch."""
    sync = _sync_of(torch, device)
    doc = M.DeviceMapDoc("m", device=device)
    doc.apply_changes([base])
    sync()
    t0 = time.perf_counter()
    doc.apply_batch(batch)
    sync()
    return doc, time.perf_counter() - t0


def adv_counter(torch, M, card: str, device, n_actors: int, n_keys: int,
                reps: int) -> dict:
    """18d, cfg2: n_actors writers set their own keys and increment one
    shared counter in one round; the counter, the length, the map and its
    conflicts against a CPU run."""
    base, changes = counter_changes(n_actors, n_keys)
    batch = M.MapChangeBatch.from_changes(changes, "m")
    n_ops = len(batch.op_kind)
    counter_run(torch, M, device, base, batch)             # warm-up
    times = []
    for _ in range(reps):
        doc, dt = counter_run(torch, M, device, base, batch)
        times.append(dt)
    cpu_doc, cpu_s = counter_run(torch, M, "cpu", base, batch)
    if doc.get("count") != n_actors or len(doc) != n_actors * n_keys + 1:
        raise AssertionError(f"18d: count {doc.get('count')}, length "
                             f"{len(doc)}")
    if (doc.to_dict() != cpu_doc.to_dict()
            or doc.conflicts != cpu_doc.conflicts):
        raise AssertionError("18d: the map or its conflicts differ from "
                             "the CPU run's")
    out = {"ops": n_ops, "reps": reps, "apply_s": times,
           "ops_per_s": _spread([n_ops / s for s in times]),
           "count": doc.get("count"), "keys": len(doc), "cpu_s": cpu_s}
    log(f"18d cfg2 map counter ({card}): {n_actors} actors x {n_keys} keys "
        f"+ 1 counter, {n_ops} ops; ops/s median "
        f"{out['ops_per_s']['median']:.0f} (range "
        f"{out['ops_per_s']['min']:.0f}-{out['ops_per_s']['max']:.0f}); "
        f"count {out['count']}, {out['keys']} keys; equal to the CPU run")
    return out


def save_load_session(am, opts, n_changes: int, run_chars: int,
                      loads: int, sync=lambda: None) -> dict:
    """run_all.py config10_save_load (:1642-1680) through `am`, either
    package's API (`opts(actor)` gives init's and load's options): a Text
    grown by n_changes inserts of run_chars chars at index 0, saved once,
    then loaded `loads` times, each load timed."""
    doc = am.change(am.init(opts("u")),
                    lambda d: d.__setitem__("t", am.Text("x")))
    for _ in range(n_changes):
        doc = am.change(doc, lambda d: d["t"].insert_at(
            0, *("ab" * (run_chars // 2))))
    sync()
    t0 = time.perf_counter()
    blob = am.save(doc)
    save_s = time.perf_counter() - t0
    times = []
    for _ in range(loads):
        t0 = time.perf_counter()
        back = am.load(blob, opts("loader"))
        sync()
        times.append(time.perf_counter() - t0)
    return {"blob": blob, "save_s": save_s, "load_s": times,
            "json": _canon(am, back), "text": str(am.to_json(back)["t"]),
            "saved_text": str(am.to_json(doc)["t"])}


def _backend_opts(M, device):
    be = M.am.backend.backend_for(device)
    return lambda actor: {"actorId": actor, "backend": be}


def adv_save_load(torch, M, card: str, device, n_changes: int,
                  run_chars: int, reps: int) -> dict:
    """18e, cfg10: save on the card backend, load timed; the save string
    byte-equal to the CPU backend's, the loaded documents equal."""
    _pinned_uuids(M)
    got = save_load_session(M.am, _backend_opts(M, device), n_changes,
                            run_chars, 1 + reps, _sync_of(torch, device))
    _pinned_uuids(M)
    want = save_load_session(M.am, _backend_opts(M, "cpu"), n_changes,
                             run_chars, 1)
    M.uuid.reset()
    del got["load_s"][0]                       # the warm-up load
    if got["text"] != got["saved_text"]:
        raise AssertionError("18e: the loaded text differs from the saved "
                             "document's")
    if got["blob"] != want["blob"] or got["json"] != want["json"]:
        raise AssertionError("18e: the save string or the loaded document "
                             "differs from the CPU backend's")
    n_chars = 1 + n_changes * run_chars
    out = {"chars": n_chars, "changes": n_changes, "reps": reps,
           "blob_bytes": len(got["blob"]), "save_ms": got["save_s"] * 1e3,
           "load_ms": _spread([s * 1e3 for s in got["load_s"]])}
    log(f"18e cfg10 save/load ({card}): {n_chars} chars in {n_changes} "
        f"changes, {out['blob_bytes']} B saved in {out['save_ms']:.2f} ms; "
        f"load median {out['load_ms']['median']:.2f} ms (range "
        f"{out['load_ms']['min']:.2f}-{out['load_ms']['max']:.2f}); save "
        f"bytes and loaded document equal to the CPU backend's")
    return out


def nested_session(am, opts, n_root: int, n_changes: int) -> dict:
    """run_all.py config7b_nested_under_large_root (:1457-1512) through
    `am`, either package's API: a root of n_root keys made in 4 changes, a
    nested board.meta map, then n_changes title edits through am.change,
    each timed whole."""
    doc = am.init(opts("user"))
    for c in range(4):
        doc = am.change(doc, lambda d, c=c: [
            d.__setitem__(f"k{c}-{i}", i) for i in range(n_root // 4)])
    doc = am.change(doc, lambda d: d.__setitem__(
        "board", {"meta": {"title": "t"}}))
    lat = []
    for i in range(n_changes):
        t0 = time.perf_counter()
        doc = am.change(doc, lambda d, i=i: d["board"]["meta"]
                        .__setitem__("title", f"v{i}"))
        lat.append(time.perf_counter() - t0)
    return {"lat": lat, "json": _canon(am, doc),
            "title": am.to_json(doc)["board"]["meta"]["title"]}


def adv_nested(torch, M, card: str, device, n_root: int,
               n_changes: int) -> dict:
    """18f, cfg7b: per-edit latency of a nested map under a large device
    root map (the keyed parent relink); the document against the CPU
    backend's."""
    _pinned_uuids(M)
    got = nested_session(M.am, _backend_opts(M, device), n_root, n_changes)
    _pinned_uuids(M)
    want = nested_session(M.am, _backend_opts(M, "cpu"), n_root, n_changes)
    M.uuid.reset()
    if got["title"] != f"v{n_changes - 1}":
        raise AssertionError(f"18f: the title reads {got['title']!r}")
    if got["json"] != want["json"]:
        raise AssertionError("18f: the document differs from the CPU "
                             "backend's")
    skip = n_changes // 5                      # run_all.py's warm-up skip
    w = np.asarray(got["lat"][skip:]) * 1e3
    out = {"root_keys": n_root, "changes": n_changes, "skip": skip,
           "p50_ms": float(np.percentile(w, 50)),
           "p99_ms": float(np.percentile(w, 99)),
           "cpu_p50_ms": float(np.percentile(
               np.asarray(want["lat"][skip:]) * 1e3, 50))}
    log(f"18f cfg7b nested edits ({card}): {n_root} root keys, "
        f"{n_changes} edits of board.meta.title; p50 {out['p50_ms']:.3f} "
        f"ms p99 {out['p99_ms']:.3f} ms (CPU backend p50 "
        f"{out['cpu_p50_ms']:.3f} ms); document equal to the CPU "
        f"backend's")
    return out


def adv_phase(torch, M, card: str, device=None, n_actors: int = ADV_ACTORS,
              two_round_base: int = ADV_BASE, reps: int = ADV_REPS,
              conflict_actors: int = CONFLICT_ACTORS,
              conflict_targets: int = CONFLICT_TARGETS,
              counter_actors: int = COUNTER_ACTORS,
              counter_keys: int = COUNTER_KEYS,
              save_changes: int = SAVE_CHANGES, save_run: int = SAVE_RUN,
              nested_root: int = NESTED_ROOT,
              nested_changes: int = NESTED_CHANGES,
              clean_commit_s: float = None) -> dict:
    """Phase 18, the JAX package's remaining workloads on `device`: 18a
    cfg5b residual-heavy, 18b cfg5c two causal rounds, 18c cfg6
    conflict-heavy, 18d cfg2 map counter, 18e cfg10 save/load, 18f cfg7b
    nested edits under a large root. Each part against a CPU run of the
    same part. The kernel counts are set to 0 before each part and read
    after its card runs. Raises on any failed check."""
    cuda = torch.device(device or "cuda").type == "cuda"
    count, launches, shapes, by_part = part_counts(M, _sync_of(torch,
                                                              device))
    t_phase = time.perf_counter()

    def counted(part, fn):
        t = time.perf_counter()
        out = count(part, fn)
        out["wall_s"] = time.perf_counter() - t
        log(f"{part} launches by shape: {by_part[part]}; part wall "
            f"{out['wall_s']:.2f} s")
        return out

    # 18a: the counts are read after the card's runs; the CPU run inside
    # adv_merge launches no kernel
    b5, base5, vis5 = residual_heavy_batch(M.TB, M.C, n_actors)
    a = counted("18a", lambda: adv_merge(
        torch, M, card, device, "18a cfg5b residual-heavy", b5, base5,
        vis5, residual_heavy_text(n_actors), reps))
    del b5
    if a["mixed_rounds"] < 1 or a["slow_fetches"] < 1:
        raise AssertionError(f"18a: no mixed round or slow_info fetch: {a}")
    if a["slow_fetch_d2h_bytes"] <= 0:
        raise AssertionError("18a: the slow_info fetch counted no bytes")
    if clean_commit_s:
        a["vs_clean"] = clean_commit_s / a["commit_s_spread"]["median"]
        log(f"18a: {a['vs_clean']:.3f} of phase 4's clean ops/s (run_all.py "
            "bounds it at >= 0.25; recorded, not asserted)")
    b5c = two_round_batch(M.TB, M.C, n_actors, two_round_base)
    vis5c = two_round_base + len(b5c.op_kind) // 2
    b = counted("18b", lambda: adv_merge(
        torch, M, card, device, "18b cfg5c two causal rounds", b5c,
        two_round_base, vis5c, two_round_text(n_actors, two_round_base),
        reps))
    del b5c
    if b["rounds"] != 2:
        raise AssertionError(f"18b: {b['rounds']} planned rounds, not 2")
    c = counted("18c", lambda: adv_conflicts(
        torch, M, card, device, conflict_actors, conflict_targets, reps))
    d = counted("18d", lambda: adv_counter(
        torch, M, card, device, counter_actors, counter_keys, reps))
    e = counted("18e", lambda: adv_save_load(
        torch, M, card, device, save_changes, save_run, reps))
    f = counted("18f", lambda: adv_nested(
        torch, M, card, device, nested_root, nested_changes))
    if cuda:
        for part in ("18a", "18b"):
            if not by_part[part]["multi_scan"]:
                raise AssertionError(f"{part}: multi_scan did not launch")
    out = {"a": a, "b": b, "c": c, "d": d, "e": e, "f": f,
           "launches": launches, "shapes": shapes,
           "launches_by_part": by_part,
           "wall_s": time.perf_counter() - t_phase}
    log(f"adversarial phase launches: {launches}; phase "
        f"{out['wall_s']:.2f} s ({card})")
    log("adv record: " + json.dumps(dict(out, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in shapes.items()})))
    return out


def profile_residual(torch, M, n_actors: int = ADV_ACTORS, top: int = 20):
    """`--workloads`: one 18a commit (cfg5b at n_actors) under cProfile
    (the host functions that took the most own time), then one under
    torch.profiler (its device time against its wall time, and the
    device operations that took the most)."""
    from torch.profiler import ProfilerActivity, profile
    batch, base_n, vis = residual_heavy_batch(M.TB, M.C, n_actors)

    def prepared():
        doc = M.DeviceTextDoc("t")
        doc.eager_materialize = True
        doc.apply_batch(base_batch(M.TB, M.C, "t", base_n))
        doc.text()
        return doc, doc.prepare_batch(batch)

    def commit(doc, plan):
        doc.commit_prepared(plan)
        doc._materialize(with_pos=False)
        if int(doc._scalars()[0]) != vis:
            raise AssertionError("profiled 18a commit: wrong n_vis")

    doc, plan = prepared()
    torch.cuda.synchronize()
    log("18a commit+materialize+sync, host profile:")
    host_profile(lambda: commit(doc, plan), top)
    del doc, plan
    doc, plan = prepared()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        commit(doc, plan)
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    log(f"18a commit+materialize+sync under torch.profiler: wall "
        f"{wall * 1e3:.3f} ms, device time {dev_us / 1e3:.3f} ms, busy "
        f"share {dev_us / 1e3 / (wall * 1e3):.4f}")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    log("self device ms | calls | device operation")
    for e in events[:top]:
        log(f"{e.self_device_time_total / 1e3:14.4f} | {e.count:5d} | "
            f"{e.key[:90]}")
    return {"wall_s": wall, "device_s": dev_us / 1e6}


# --- the soak campaign (scripts/soak.py's sessions other than federation) --

SOAK_SEEDS = (0, 1, 2)         # 19: tests/test_soak_smoke.py's seeds, at the
SOAK_CLIENTS = 1_000           # soak's defaults; plus one --service
SOAK_CLIENT_TICKS = 40         # --clients 1000 session (soak.py:1564-1569)
SOAK_TICK_STEP_S = 10e-6       # the service tick's modeled clock (TickClock)
SOAK_TIMING = ("p50_tick_ms", "p99_tick_ms", "max_tick_ms",
               "tick_p99_ms_telemetry", "page_in_p99_ms")


def _check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _render(am, doc) -> str:
    """A document as `_converged` compares it, as JSON text."""
    return json.dumps({k: (str(v) if hasattr(v, "elems") else v)
                       for k, v in am.to_json(doc).items()},
                      sort_keys=True, default=str)


def _doc_states(am, docs) -> list:
    """Each document's save() digest and rendered to_json."""
    return [(_digest(am.save(d).encode()), _render(am, d)) for d in docs]


def _histories(am, doc) -> list:
    return sorted(json.dumps(c, sort_keys=True)
                  for c in am.get_all_changes(doc))


def _soak_api(M, device):
    """(am, be, init): the port's API, the backend namespace of
    `device`, and init(actor) binding a new document to it."""
    am = M.am
    be = am.backend.backend_for(device)
    return am, be, lambda actor: am.init({"actorId": actor, "backend": be})


def _check_on(M, docs, device, what: str):
    _check(all(_on_device(M, d, device) for d in docs),
           f"{what}: a document left {device or 'cuda'}")


def _nt(d):
    """`d` as plain JSON data less the wall-clock fields (SOAK_TIMING)."""
    d = json.loads(json.dumps(d, sort_keys=True, default=str))
    if isinstance(d, dict):
        return {k: _nt(v) for k, v in d.items() if k not in SOAK_TIMING}
    return d


class TickClock:
    """The clock `SyncService.tick` reads in phase 19: each read advances
    it by `step_s`. The tick's admission deadline
    (`ServiceConfig.tick_budget_ms`) reads the wall clock, so which
    tenants it sheds, and with them every document of a service session,
    depends on how fast the host admits; on this clock the deadline cuts
    the admission order after budget / step_s reads in every run of a
    seed, on the card and on the CPU alike. `installed(module)` puts it
    in place of a service server module's `time` for a `with` block."""

    def __init__(self, step_s: float = SOAK_TICK_STEP_S):
        self.step_s, self.t = step_s, 0.0

    def perf_counter(self) -> float:
        self.t += self.step_s
        return self.t

    def installed(self, server_module):
        import contextlib
        from types import SimpleNamespace

        @contextlib.contextmanager
        def cm():
            real = server_module.time
            server_module.time = SimpleNamespace(
                perf_counter=self.perf_counter)
            try:
                yield self
            finally:
                server_module.time = real
        return cm()


def soak_general(torch, M, device, seed: int) -> dict:
    """scripts/soak.py session_general (:109): nested histories with
    undo/redo and merge interleavings on three peers."""
    am, be, init = _soak_api(M, device)
    rng = np.random.default_rng(seed)
    base = am.change(init("base"), lambda d: (
        d.__setitem__("t", am.Text("seed")), d.__setitem__("m", {"k": 0})))
    changes = am.get_all_changes(base)
    peers = [am.apply_changes(init(f"actor-{i}"), changes)
             for i in range(3)]
    for _ in range(int(rng.integers(15, 30))):
        i = int(rng.integers(0, len(peers)))
        act = int(rng.integers(0, 6))
        if act == 0:
            k = KEYS[int(rng.integers(0, len(KEYS)))]
            v = _rand_value(rng)
            peers[i] = am.change(peers[i],
                                 lambda d, k=k, v=v: d.__setitem__(k, v))
        elif act == 1:
            peers[i] = _text_edit(am, peers[i], rng)
        elif act == 2:
            n = int(rng.integers(0, 50))
            peers[i] = am.change(
                peers[i], lambda d, n=n: d["m"].__setitem__("k", n))
        elif act == 3 and am.can_undo(peers[i]):
            peers[i] = am.undo(peers[i])
        elif act == 4 and am.can_redo(peers[i]):
            peers[i] = am.redo(peers[i])
        else:
            j = int(rng.integers(0, len(peers)))
            if j != i:
                peers[i] = am.merge(peers[i], peers[j])
    order = rng.permutation(len(peers))
    for _ in range(2):
        for i in order:
            for j in order:
                if i != j:
                    peers[i] = am.merge(peers[i], peers[j])
    ok, diff = _converged(am, peers)
    _check(ok, f"general seed {seed} diverged: {diff}")
    back = am.load(am.save(peers[0]), {"backend": be})
    ok, diff = _converged(am, [peers[0], back])
    _check(ok, f"general seed {seed} save/load mismatch: {diff}")
    _check_on(M, peers + [back], device, f"general seed {seed}")
    return {"docs": _doc_states(am, peers + [back])}


def soak_conflict(torch, M, device, seed: int) -> dict:
    """scripts/soak.py session_conflict (:156): same-key and same-element
    races on four peers with partial pairwise sync."""
    am, be, init = _soak_api(M, device)
    rng = np.random.default_rng(seed)
    base = am.change(init("base"), lambda d: (
        d.__setitem__("t", am.Text("abcdef")),
        *[d.__setitem__(k, 0) for k in KEYS]))
    changes = am.get_all_changes(base)
    peers = [am.apply_changes(init(f"w{i}"), changes)
             for i in range(4)]
    for step in range(int(rng.integers(10, 20))):
        for i in range(len(peers)):
            act = int(rng.integers(0, 3))
            if act == 0:
                k = KEYS[int(rng.integers(0, len(KEYS)))]
                peers[i] = am.change(
                    peers[i], lambda d, k=k, i=i, s=step:
                    d.__setitem__(k, f"w{i}s{s}"))
            elif act == 1 and len(peers[i]["t"]):
                idx = int(rng.integers(0, len(peers[i]["t"])))
                peers[i] = am.change(
                    peers[i], lambda d, idx=idx, i=i:
                    d["t"].set(min(idx, len(d["t"]) - 1), str(i)))
            else:
                peers[i] = _text_edit(am, peers[i], rng)
        if rng.integers(0, 2):
            i, j = rng.choice(len(peers), 2, replace=False)
            peers[int(i)] = am.merge(peers[int(i)], peers[int(j)])
    for _ in range(2):
        for i in range(len(peers)):
            for j in range(len(peers)):
                if i != j:
                    peers[i] = am.merge(peers[i], peers[j])
    ok, diff = _converged(am, peers)
    _check(ok, f"conflict seed {seed} diverged: {diff}")
    conflicts = {}
    for k in KEYS:
        refc = am.get_conflicts(peers[0], k)
        for p in peers[1:]:
            _check(am.get_conflicts(p, k) == refc,
                   f"conflict seed {seed}: conflicts diverged at {k}")
        conflicts[k] = json.dumps(refc, sort_keys=True, default=str)
    _check_on(M, peers, device, f"conflict seed {seed}")
    return {"docs": _doc_states(am, peers), "conflicts": conflicts}


def soak_lossy(torch, M, device, seed: int) -> dict:
    """scripts/soak.py session_lossy (:199): Connection sync over a
    dropping in-memory network with churn."""
    am, be, init = _soak_api(M, device)
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 4))
    sets = [am.DocSet(backend=be) for _ in range(n)]
    doc0 = am.change(init("origin"),
                     lambda d: d.__setitem__("t", am.Text("start")))
    base_changes = am.get_all_changes(doc0)
    for i, ds in enumerate(sets):
        ds.set_doc("doc", am.apply_changes(init(f"peer-{i}"),
                                           base_changes))
    queues: dict = {}
    conns: dict = {}

    def wire(a: int, b: int):
        ca = am.Connection(sets[a], lambda m, a=a, b=b:
                           queues.setdefault((a, b), []).append(m))
        cb = am.Connection(sets[b], lambda m, a=a, b=b:
                           queues.setdefault((b, a), []).append(m))
        conns[(a, b)], conns[(b, a)] = ca, cb
        ca.open()
        cb.open()

    def deliver(edge, drop_p: float):
        q = queues.get(edge, [])
        while q:
            msg = q.pop(0)
            if rng.random() < drop_p:
                continue
            conns[(edge[1], edge[0])].receive_msg(msg)

    for a in range(n):
        for b in range(a + 1, n):
            wire(a, b)
    edges = list(conns.keys())
    for step in range(int(rng.integers(10, 25))):
        i = int(rng.integers(0, n))
        doc = sets[i].get_doc("doc")
        sets[i].set_doc("doc", _text_edit(am, doc, rng))
        for edge in edges:
            deliver(edge, drop_p=0.3)
        if rng.integers(0, 5) == 0:
            a, b = edges[int(rng.integers(0, len(edges)))]
            if a < b:
                conns[(a, b)].close()
                conns[(b, a)].close()
                queues.pop((a, b), None)
                queues.pop((b, a), None)
                wire(a, b)
    for a in range(n):
        for b in range(a + 1, n):
            conns[(a, b)].close()
            conns[(b, a)].close()
            queues.pop((a, b), None)
            queues.pop((b, a), None)
            wire(a, b)
    for _ in range(4):
        for edge in edges:
            deliver(edge, drop_p=0.0)
    docs = [ds.get_doc("doc") for ds in sets]
    ok, diff = _converged(am, docs)
    _check(ok, f"lossy seed {seed} diverged: {diff}")
    _check_on(M, docs, device, f"lossy seed {seed}")
    return {"docs": _doc_states(am, docs)}


def soak_table(torch, M, device, seed: int) -> dict:
    """scripts/soak.py session_table (:273): concurrent Table row
    add/update/remove on three peers with partial sync. `to_json`
    renders the table's rows, so the states compare them."""
    am, be, init = _soak_api(M, device)
    rng = np.random.default_rng(seed)
    base = am.change(init("base"),
                     lambda d: d.__setitem__("t", am.Table()))
    changes = am.get_all_changes(base)
    peers = [am.apply_changes(init(f"tw{i}"), changes)
             for i in range(3)]
    known_rows: list = []
    for step in range(int(rng.integers(12, 24))):
        i = int(rng.integers(0, len(peers)))
        act = int(rng.integers(0, 4))
        if act == 0 or not known_rows:
            holder = {}

            def add(d, i=i, s=step, holder=holder):
                holder["id"] = d["t"].add(
                    {"by": f"tw{i}", "step": s,
                     "v": int(rng.integers(0, 99))})
            peers[i] = am.change(peers[i], add)
            known_rows.append(holder["id"])
        elif act == 1:
            rid = known_rows[int(rng.integers(0, len(known_rows)))]
            if peers[i]["t"].by_id(rid) is not None:
                peers[i] = am.change(
                    peers[i], lambda d, rid=rid, s=step:
                    d["t"].by_id(rid).__setitem__("v", 1000 + s))
        elif act == 2:
            rid = known_rows[int(rng.integers(0, len(known_rows)))]
            if peers[i]["t"].by_id(rid) is not None:
                peers[i] = am.change(
                    peers[i], lambda d, rid=rid: d["t"].remove(rid))
        else:
            j = int(rng.integers(0, len(peers)))
            if j != i:
                peers[i] = am.merge(peers[i], peers[j])
    for _ in range(2):
        for i in range(len(peers)):
            for j in range(len(peers)):
                if i != j:
                    peers[i] = am.merge(peers[i], peers[j])
    ok, diff = _converged(am, peers)
    _check(ok, f"table seed {seed} diverged: {diff}")
    _check_on(M, peers, device, f"table seed {seed}")
    return {"docs": _doc_states(am, peers)}


def _quiesce(pump, channels, links, what: str, rounds: int = 400):
    for _ in range(rounds):
        pump(1)
        if all(ch.idle for ch in channels.values()) \
                and all(ln.idle for ln in links.values()):
            return
    raise AssertionError(f"{what}: channels never quiesced")


def soak_chaos(torch, M, device, seed: int) -> dict:
    """scripts/soak.py session_chaos (:318): three peers' Connection sync
    over ChaosLink + ResilientChannel (drop, dup, reorder, delay and one
    partition/heal cycle); byte-identical convergence after the heal."""
    am, be, init = _soak_api(M, device)
    rng = np.random.default_rng(seed)
    n = 3
    sets = [am.DocSet(backend=be) for _ in range(n)]
    doc0 = am.change(init("origin"),
                     lambda d: d.__setitem__("t", am.Text("start")))
    base = am.get_all_changes(doc0)
    for i, ds in enumerate(sets):
        ds.set_doc("doc", am.apply_changes(init(f"peer-{i}"), base))
    drop = float(rng.uniform(0.05, 0.30))
    dup = float(rng.uniform(0.0, 0.20))
    reorder = float(rng.uniform(0.05, 0.30))
    delay = float(rng.uniform(0.0, 0.30))
    edges = [(a, b) for a in range(n) for b in range(n) if a != b]
    links, channels, conns = {}, {}, {}
    for a, b in edges:
        links[(a, b)] = M.res.ChaosLink(
            lambda env, a=a, b=b: channels[(b, a)].on_wire(env),
            rng=rng, drop=drop, dup=dup, reorder=reorder, delay=delay)
    for a, b in edges:
        channels[(a, b)] = M.res.ResilientChannel(
            links[(a, b)].send,
            lambda msg, a=a, b=b: conns[(a, b)].receive_msg(msg),
            seed=seed * 7919 + a * 97 + b)
    for a, b in edges:
        conns[(a, b)] = am.Connection(sets[a], channels[(a, b)].send)
        conns[(a, b)].open()

    def pump(rounds: int = 1):
        for _ in range(rounds):
            for e in edges:
                links[e].pump()
            for e in edges:
                channels[e].tick()

    n_steps = int(rng.integers(12, 22))
    part_at = int(rng.integers(2, n_steps - 6))
    part_len = int(rng.integers(2, 6))
    pa, pb = (int(x) for x in rng.choice(n, 2, replace=False))
    for step in range(n_steps):
        if step == part_at:
            links[(pa, pb)].partition()
            links[(pb, pa)].partition()
        if step == part_at + part_len:
            links[(pa, pb)].heal()
            links[(pb, pa)].heal()
        i = int(rng.integers(0, n))
        sets[i].set_doc("doc", _text_edit(am, sets[i].get_doc("doc"), rng))
        pump(1)
    for e in edges:
        links[e].heal()
        links[e].drop = links[e].dup = 0.0
        links[e].reorder = links[e].delay = 0.0
    _quiesce(pump, channels, links, f"chaos seed {seed}")
    docs = [ds.get_doc("doc") for ds in sets]
    ok, diff = _converged(am, docs)
    _check(ok, f"chaos seed {seed} diverged: {diff}")
    hists = [_histories(am, d) for d in docs]
    _check(hists.count(hists[0]) == len(hists),
           f"chaos seed {seed}: change histories diverged after heal")
    for ds in sets:
        gate = getattr(ds, "_inbound_gate", None)
        _check(not gate or gate.quarantined("doc") == 0,
               f"chaos seed {seed}: quarantine not drained")
    _check_on(M, docs, device, f"chaos seed {seed}")
    return {"docs": _doc_states(am, docs), "history": hists[0]}


def soak_checkpoint(torch, M, device, seed: int) -> dict:
    """scripts/soak.py session_checkpoint (:412): chaos sync with
    periodic async captures of one peer, which restarts mid-run from its
    last completed bundle (on the same device) and catches up."""
    am, be, init = _soak_api(M, device)
    rng = np.random.default_rng(seed)
    n = 3
    sets = [am.DocSet(backend=be) for _ in range(n)]
    doc0 = am.change(init("origin"),
                     lambda d: d.__setitem__("t", am.Text("start")))
    base = am.get_all_changes(doc0)
    for i, ds in enumerate(sets):
        ds.set_doc("doc", am.apply_changes(init(f"peer-{i}"), base))
    drop = float(rng.uniform(0.05, 0.25))
    reorder = float(rng.uniform(0.05, 0.25))
    links, channels, conns = {}, {}, {}

    def wire_edge(a, b):
        links[(a, b)] = M.res.ChaosLink(
            lambda env, a=a, b=b: channels[(b, a)].on_wire(env),
            rng=rng, drop=drop, dup=0.05, reorder=reorder, delay=0.1)
        channels[(a, b)] = M.res.ResilientChannel(
            links[(a, b)].send,
            lambda msg, a=a, b=b: conns[(a, b)].receive_msg(msg),
            seed=seed * 7919 + a * 97 + b)
        conns[(a, b)] = am.Connection(sets[a], channels[(a, b)].send)

    edges = [(a, b) for a in range(n) for b in range(n) if a != b]
    for a, b in edges:
        wire_edge(a, b)
    for e in edges:
        conns[e].open()

    def pump(rounds: int = 1):
        for _ in range(rounds):
            for e in edges:
                links[e].pump()
            for e in edges:
                channels[e].tick()

    victim = int(rng.integers(0, n))
    writer = am.AsyncCheckpointer()
    handles: list = []
    bundle = None
    n_steps = int(rng.integers(14, 22))
    restart_at = int(rng.integers(6, n_steps - 4))
    restarted = False
    try:
        for step in range(n_steps):
            i = int(rng.integers(0, n))
            sets[i].set_doc("doc",
                            _text_edit(am, sets[i].get_doc("doc"), rng))
            if step % 3 == 0:
                state = am.Frontend.get_backend_state(
                    sets[victim].get_doc("doc"))
                handles.append(writer.capture_async(state))
            if step == restart_at:
                for h in handles:
                    bundle = h.result(30)
                _check(bundle is not None, "no checkpoint completed")
                for a, b in edges:
                    if victim in (a, b):
                        conns[(a, b)].close()
                sets[victim] = am.DocSet(backend=be)
                sets[victim].bootstrap_doc("doc", bundle)
                _check_on(M, [sets[victim].get_doc("doc")], device,
                          f"checkpoint seed {seed}: the restart")
                for a, b in edges:
                    if victim in (a, b):
                        wire_edge(a, b)
                        conns[(a, b)].open()
                restarted = True
            pump(1)
    finally:
        writer.close()
    _check(restarted, f"checkpoint seed {seed}: no restart")
    for e in edges:
        links[e].heal()
        links[e].drop = links[e].dup = 0.0
        links[e].reorder = links[e].delay = 0.0
    _quiesce(pump, channels, links, f"checkpoint seed {seed}")
    docs = [ds.get_doc("doc") for ds in sets]
    ok, diff = _converged(am, docs)
    _check(ok, f"checkpoint seed {seed} diverged after restart: {diff}")
    hists = [_histories(am, d) for d in docs]
    _check(hists.count(hists[0]) == len(hists),
           f"checkpoint seed {seed}: change histories diverged after "
           "restart")
    _check_on(M, docs, device, f"checkpoint seed {seed}")
    return {"docs": _doc_states(am, docs), "history": hists[0],
            "bundle_sha256": _digest(bytes(bundle))}


class SoakClient:
    """scripts/soak.py `_SvcClient` (:561): one tenant endpoint — a
    DocSet on the backend namespace `be`, a Connection and a
    ResilientChannel over a pair of directed ChaosLinks into `svc`."""

    __slots__ = ("tid", "room_id", "ds", "chan", "conn", "c2s", "s2c",
                 "slow", "alive")

    def __init__(self, M, be, svc, tid, room_id, base_changes, actor,
                 link_seed, chaos, empty=False):
        am = M.am
        self.tid = tid
        self.room_id = room_id
        self.slow = 1
        self.alive = True
        self.ds = am.DocSet(backend=be)
        self.ds._lineage_site = tid
        if not empty:
            self.ds.set_doc(room_id, am.apply_changes(
                am.init({"actorId": actor, "backend": be}), base_changes))
        self.c2s = M.res.ChaosLink(
            lambda env: (svc.session(tid) is not None
                         and svc.session(tid).on_wire(env)),
            seed=link_seed, **chaos)
        self.s2c = M.res.ChaosLink(lambda env: self.chan.on_wire(env),
                                   seed=link_seed + 1, **chaos)
        sess = svc.connect(tid, room_id, self.s2c.send, seed=link_seed + 2)
        _check(sess is not None, f"{tid}: connect refused")
        self.chan = M.res.ResilientChannel(self.c2s.send, None,
                                           seed=link_seed + 3)
        self.conn = am.Connection(self.ds, self.chan.send)
        self.chan._deliver = self.conn.receive_msg
        self.conn.open()

    def pump(self):
        self.c2s.pump()
        self.s2c.pump()
        self.chan.tick()

    def heal(self):
        for ln in (self.c2s, self.s2c):
            ln.heal()
            ln.drop = ln.dup = ln.reorder = ln.delay = 0.0
        self.slow = 1

    def idle(self):
        return self.chan.idle and self.c2s.idle and self.s2c.idle


def _validate_scrape(M, url: str, metrics: dict):
    """scripts/soak.py `_validate_scrape` (:541): the live endpoint's
    exposition page passes `validate_prom` and /describe parses as the
    postmortem schema."""
    import urllib.request
    page = urllib.request.urlopen(url + "/metrics", timeout=10) \
        .read().decode()
    counts = M.prom.validate_prom(page)
    dump = json.loads(
        urllib.request.urlopen(url + "/describe", timeout=10).read())
    _check(dump.get("schema") == "amtpu-postmortem-v1", dump.get("schema"))
    metrics.update(scrape_ok=True, scrape_families=counts["families"],
                   scrape_samples=counts["samples"])


def soak_service(torch, M, device, seed: int, n_clients: int = 24,
                 n_ticks: int = 30, room_size: int = 4,
                 quiesce_ticks: int = 400, scrape: bool = False) -> dict:
    """scripts/soak.py session_service (:618): `n_clients` tenant
    sessions over chaotic links into one SyncService on `device`, with
    partitions, slow peers, kills and rejoins; the soak's acceptance
    bars (`_service_scenario`). With `scrape`, the Prometheus endpoint is
    served live for the session and checked over loopback HTTP. Returns
    the soak's metrics, the service's describe() and every room's
    documents. A failure writes the service's postmortem to
    chiprun_out/service_postmortem.json before it re-raises."""
    lin = M.lineage
    lineage_full = (lin.ENABLED and lin.ledger() is not None
                    and lin.ledger().rate == 1)
    cfg = M.service.ServiceConfig(
        heartbeat_ticks=12, suspect_grace_ticks=12, max_retries=24,
        recv_window=256,
        tick_budget_ms=max(0.5, n_clients / 200.0)
        * (1.5 if lineage_full else 1.0),
        default_budget=M.service.TenantBudget(ops_per_tick=64,
                                              bytes_per_tick=32 * 1024,
                                              inbox_cap=32),
        device=device)
    svc = M.service.SyncService(cfg)
    if lin.ENABLED:
        lin.clear()
    metrics: dict = {}
    scrape_srv = svc.serve_metrics() if scrape else None
    try:
        rooms = _service_scenario(M, device, svc, cfg, seed, n_clients,
                                  n_ticks, room_size, quiesce_ticks,
                                  metrics)
        if scrape_srv is not None:
            _validate_scrape(M, scrape_srv.url, metrics)
    except BaseException:
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "chiprun_out")
        try:
            os.makedirs(out_dir, exist_ok=True)
            svc.write_postmortem(os.path.join(out_dir,
                                              "service_postmortem.json"))
            log(f"19: service postmortem written to {out_dir}")
        except Exception as dump_exc:   # noqa: BLE001 - never mask
            log(f"19: postmortem dump failed: {dump_exc!r}")
        raise
    finally:
        if scrape_srv is not None:
            scrape_srv.close()
    return {"metrics": metrics, "describe": svc.describe(), "rooms": rooms}


def _service_scenario(M, device, svc, cfg, seed, n_clients, n_ticks,
                      room_size, quiesce_ticks, metrics) -> dict:
    """scripts/soak.py `_service_scenario` (:714): the fault schedule,
    the drain and the acceptance asserts; fills `metrics` as the soak
    fills PROFILE_METRICS["service"]. -> each room's documents (server
    first, then its live members)."""
    import math
    am, be, init = _soak_api(M, device)
    rng = np.random.default_rng(seed)
    n_rooms = max(1, math.ceil(n_clients / room_size))
    base_changes: dict = {}
    for g in range(n_rooms):
        room_id = f"room-{g}"
        doc0 = am.change(init(f"{room_id}-origin"), lambda d: (
            d.__setitem__("t", am.Text("start")), d.__setitem__("m", {})))
        base_changes[room_id] = am.get_all_changes(doc0)
        svc.seed_doc(room_id, am.apply_changes(init(f"server-{g}"),
                                               base_changes[room_id]))
        svc.room(room_id).hub.snapshot_min_changes = 8
    chaos = {"drop": float(rng.uniform(0.02, 0.10)),
             "dup": float(rng.uniform(0.0, 0.05)),
             "reorder": float(rng.uniform(0.02, 0.10)),
             "delay": float(rng.uniform(0.0, 0.10))}
    clients: dict = {}
    epoch: dict = {}

    def wire(tid: str, room_id: str, empty: bool = False):
        e = epoch.get(tid, 0)
        clients[tid] = SoakClient(
            M, be, svc, tid, room_id, base_changes[room_id],
            actor=f"c-{tid}-e{e}",
            link_seed=seed * 104729 + int(tid.split("-")[-1]) * 13 + e * 7,
            chaos=chaos, empty=empty)

    for i in range(n_clients):
        wire(f"{seed}-{i}", f"room-{i % n_rooms}")
    ids = list(clients)
    n_slow = max(1, n_clients // 12)
    for tid in rng.choice(ids, n_slow, replace=False):
        clients[str(tid)].slow = 4
    n_part = max(1, n_clients // 12)
    part_victims = [str(t) for t in rng.choice(ids, n_part, replace=False)]
    part_at = {t: int(rng.integers(3, max(4, n_ticks - 10)))
               for t in part_victims}
    part_len = {t: int(rng.integers(3, 9)) for t in part_victims}
    n_kill = max(1, n_clients // 16)
    kill_order = [str(t) for t in rng.choice(ids, n_kill, replace=False)]
    kill_at = {t: int(rng.integers(6, max(7, n_ticks - 4)))
               for t in kill_order}
    rejoiners = set(kill_order[: len(kill_order) // 2])
    rejoin_at = {t: kill_at[t] + int(rng.integers(4, 10))
                 for t in rejoiners}
    killed: set = set()
    n_kills_done = 0
    n_rejoins_done = 0

    def live_room_members(room_id):
        return [c for c in clients.values()
                if c.room_id == room_id and c.alive]

    def pump_all(tick_no: int):
        for c in clients.values():
            if c.alive and tick_no % c.slow == 0:
                c.pump()
        svc.tick()

    for t in range(n_ticks):
        for tid in part_victims:
            c = clients[tid]
            if t == part_at[tid] and c.alive:
                c.c2s.partition()
                c.s2c.partition()
            if t == part_at[tid] + part_len[tid]:
                c.c2s.heal()
                c.s2c.heal()
        for tid, at in kill_at.items():
            c = clients[tid]
            if t == at and c.alive and len(live_room_members(c.room_id)) > 1:
                c.alive = False
                killed.add(tid)
                n_kills_done += 1
        for tid, at in rejoin_at.items():
            if t == at and tid in killed:
                killed.discard(tid)
                epoch[tid] = epoch.get(tid, 0) + 1
                n_rejoins_done += 1
                wire(tid, clients[tid].room_id, empty=True)
        n_edit = max(1, n_clients // 20)
        for tid in rng.choice(ids, n_edit, replace=False):
            c = clients[str(tid)]
            if not c.alive:
                continue
            doc = c.ds.get_doc(c.room_id)
            if doc is None:
                continue
            if int(rng.integers(0, 3)) == 0:
                doc = _text_edit(am, doc, rng)
            else:
                k = KEYS[int(rng.integers(0, len(KEYS)))]
                v = int(rng.integers(0, 999))
                doc = am.change(doc, lambda d, k=k, v=v:
                                d["m"].__setitem__(k, v))
            c.ds.set_doc(c.room_id, doc)
        pump_all(t)

    for c in clients.values():
        c.heal()
    for tid in killed:
        room_id = clients[tid].room_id
        room = svc.room(room_id)
        doc = room.doc_set.get_doc(room_id)
        if doc is not None:
            room.doc_set.set_doc(room_id, am.change(
                doc, lambda d: d["m"].__setitem__("_drain", 1)))
    n_orphan_rejoins = 0
    for q in range(quiesce_ticks):
        for tid, c in list(clients.items()):
            if c.alive and svc.session(tid) is None:
                epoch[tid] = epoch.get(tid, 0) + 1
                n_orphan_rejoins += 1
                wire(tid, c.room_id, empty=True)
        pump_all(q)
        if svc.idle() \
                and all(c.idle() for c in clients.values() if c.alive) \
                and all(svc.session(tid) is None for tid in killed):
            break
    else:
        raise AssertionError(
            f"service seed {seed}: never quiesced "
            f"(unevicted={[t for t in killed if svc.session(t)]}, "
            f"metrics={svc.metrics()})")

    svc.probe_lag()
    m = svc.metrics()
    metrics.clear()
    metrics.update(m, n_clients=n_clients, n_rooms=n_rooms,
                   killed=n_kills_done, rejoined=n_rejoins_done,
                   orphan_rejoins=n_orphan_rejoins,
                   tick_p99_ms_telemetry=svc.tick_p99_ms_telemetry())
    rooms = {}
    for g in range(n_rooms):
        room_id = f"room-{g}"
        server_doc = svc.room(room_id).doc_set.get_doc(room_id)
        members = live_room_members(room_id)
        if server_doc is None:
            _check(not members, f"room {room_id} lost its server replica")
            continue
        docs = [server_doc] + [c.ds.get_doc(room_id) for c in members]
        ok, diff = _converged(am, docs)
        _check(ok, f"service seed {seed} room {room_id} diverged: {diff}")
        hists = [_histories(am, d) for d in docs]
        _check(hists.count(hists[0]) == len(hists),
               f"service seed {seed} room {room_id}: histories diverged")
        _check_on(M, docs, device, f"service seed {seed} {room_id}")
        rooms[room_id] = _doc_states(am, docs)
    _check(m["peak_inbox"] <= cfg.default_budget.inbox_cap
           + cfg.recv_window, m)
    _check(m["peak_recv_buf"] <= cfg.recv_window, m)
    _check(m["peak_parked"] <= cfg.quarantine_global_capacity, m)
    for g in range(n_rooms):
        gate = svc.room(f"room-{g}").gate
        _check(gate._n_parked == 0,
               f"service seed {seed}: room-{g} quarantine not drained")
    for c in clients.values():
        if c.alive:
            _check(len(c.chan._recv_buf) <= 1024, c.tid)
    _check(m["max_starved_streak"] <= 2 * cfg.starvation_boost_ticks, m)
    for tid in killed:
        _check(svc.reclaimed(tid),
               f"service seed {seed}: tenant {tid} not reclaimed after "
               "eviction")
    _check(m["evictions"] >= n_kills_done, m)
    lag = svc.replication_lag()
    laggards = {t: v for t, v in lag.items() if v["ops"]}
    _check(not laggards,
           f"service seed {seed}: replication lag nonzero at quiescence: "
           f"{dict(list(laggards.items())[:5])}")
    _check(m["max_lag_ops"] == 0 and m["max_lag_ticks"] == 0, m)
    _lineage_acceptance(M, svc, clients, seed, metrics)
    return rooms


def _lineage_acceptance(M, svc, clients, seed, metrics):
    """scripts/soak.py `_lineage_acceptance` (:931), when lineage
    sampling is on: >= 99% of the sampled changes the server committed
    show a complete origin-to-visibility chain on every surviving
    replica of their room."""
    lin = M.lineage
    led = lin.ledger()
    if led is None or not lin.ENABLED:
        return
    live_by_room: dict = {}
    for tid, c in clients.items():
        if c.alive and svc.session(tid) is not None:
            live_by_room.setdefault(c.room_id, set()).add(tid)
    total = complete = 0
    incomplete_sample = []
    for ch in led.chains():
        vis = led.visible_sites(ch)
        for room_id in {d for d in ch["docs"]
                        if isinstance(d, str) and d in svc._rooms}:
            server_site = f"svc:{room_id}"
            if server_site not in vis:
                continue
            origin = ch["origin_site"] or ""
            if origin.startswith("c-") and "-e" in origin:
                origin_replica = origin[2:].rsplit("-e", 1)[0]
            else:
                origin_replica = server_site
            expected = {server_site} | live_by_room.get(room_id, set())
            expected.discard(origin_replica)
            total += 1
            if ch["origin_ns"] is not None and expected <= vis:
                complete += 1
            elif len(incomplete_sample) < 5:
                incomplete_sample.append(
                    (ch["actor"], ch["seq"], sorted(expected - vis),
                     [h[0] for h in ch["hops"]]))
    ratio = complete / total if total else 1.0
    metrics.update(
        lineage_rate=led.rate, lineage_sampled_chains=led.n_chains,
        lineage_commit_population=total,
        lineage_complete_ratio=round(ratio, 4),
        lineage_hops_per_chain=round(
            led.stats["hops_recorded"] / max(1, led.stats[
                "chains_started"]), 2),
        lineage_max_quarantine_dwell_ms=led.max_dwell_ms("quar/park"),
        lineage_max_defer_dwell_ms=led.max_dwell_ms("svc/defer"),
        lineage_visibility_p99_ms=led.visibility_ms(0.99))
    _check(total > 0,
           f"service seed {seed}: lineage sampling enabled but no sampled "
           f"chain committed at any server replica (rate {led.rate})")
    _check(ratio >= 0.99,
           f"service seed {seed}: only {ratio:.2%} of sampled changes "
           f"have a complete origin->visibility chain on every surviving "
           f"replica; first incomplete: {incomplete_sample}")


def _sharded_stream(seed: int, n_docs: int, n_actors: int, n_seqs: int,
                    hot_doc: str, hot_factor: int, n_chunks: int):
    """scripts/soak.py `_sharded_stream` (:992): per-doc causally
    chained change lists, shuffled across docs and seqs, ~10%
    duplicated, chunked into `n_chunks` serving rounds."""
    rng = np.random.default_rng(seed * 7919 + 17)
    docs = [f"sdoc-{seed}-{i}" for i in range(n_docs)]
    flat = []
    for di, doc in enumerate(docs):
        seqs = n_seqs * (hot_factor if doc == hot_doc else 1)
        for s in range(1, seqs + 1):
            for a in range(n_actors):
                actor, run = f"w{a}", 4
                base = (s - 1) * run + 1
                key = "_head" if s == 1 else f"{actor}:{base - 1}"
                ops = []
                for k in range(run):
                    ctr = base + k
                    ops.append({"action": "ins", "obj": doc, "key": key,
                                "elem": ctr})
                    ops.append({"action": "set", "obj": doc,
                                "key": f"{actor}:{ctr}",
                                "value": chr(97 + (ctr + a + di) % 26)})
                    key = f"{actor}:{ctr}"
                deps = {} if s == 1 else \
                    {f"w{b}": s - 1 for b in range(n_actors) if b != a}
                flat.append((doc, {"actor": actor, "seq": s,
                                   "deps": deps, "ops": ops}))
    rng.shuffle(flat)
    for i in rng.choice(len(flat), max(1, len(flat) // 10),
                        replace=False):
        flat.insert(int(rng.integers(0, len(flat))), flat[int(i)])
    per = max(1, -(-len(flat) // n_chunks))
    rounds = []
    for c in range(0, len(flat), per):
        chunk: dict = {}
        for doc, ch in flat[c: c + per]:
            chunk.setdefault(doc, []).append(ch)
        rounds.append(chunk)
    return docs, rounds


def _soak_mesh(torch, M, device, n_shards: int):
    """A ShardedDocSet of `n_shards` lanes on `device` (None: the card's
    streams), at the soak's capacity."""
    devices = None if device is None else [torch.device(device)]
    return M.shard.ShardedDocSet(n_shards=n_shards, capacity=64,
                                 devices=devices)


def soak_sharded(torch, M, device, seed: int, n_docs: int = 8,
                 n_actors: int = 2, n_seqs: int = 4, shard_counts=(1, 8),
                 parallel_lanes: str = None) -> dict:
    """scripts/soak.py session_sharded (:1038): the same seeded chaotic
    stream served at every shard count, with a telemetry-triggered
    migration of the hot doc on the multi-shard mesh, converges to equal
    captures and texts. The executor assertion follows the port's rule:
    lane workers run when the lanes span more than one device
    (`parallel_lanes_enabled(lane_devices(...))`), so on one card or the
    CPU every leg is sequential unless `parallel_lanes` sets
    AMTPU_PARALLEL_LANES for the call ("1": workers on every leg)."""
    P = M.lanes
    max_shards = max(shard_counts)
    ids = [f"sdoc-{seed}-{i}" for i in range(n_docs)]
    homes = [M.shard.hash_shard(d, max_shards) for d in ids]
    hot_doc = ids[0]
    for i, d in enumerate(ids):
        if homes.count(homes[i]) >= 2:
            hot_doc = d
            break
    results = {}
    exec_stats = {}
    prior = os.environ.get("AMTPU_PARALLEL_LANES")
    if parallel_lanes is not None:
        os.environ["AMTPU_PARALLEL_LANES"] = parallel_lanes
    try:
        for n_shards in shard_counts:
            docs, rounds = _sharded_stream(seed, n_docs, n_actors, n_seqs,
                                           hot_doc, hot_factor=4,
                                           n_chunks=6)
            mesh = _soak_mesh(torch, M, device, n_shards)
            try:
                if n_shards >= 2:
                    mesh.attach_rebalancer(ratio=2.0, min_ops=64,
                                           cooldown=2)
                mesh.deliver_rounds(rounds)
                ex = mesh._executor
                if P.parallel_lanes_enabled(P.lane_devices(mesh.lanes)):
                    _check(ex is not None, f"sharded seed {seed} "
                           f"({n_shards} shards): parallel lanes enabled "
                           "but no executor engaged")
                if ex is not None:
                    _check(ex.stats["barriers"] > 0
                           and ex.stats["errors"] == 0
                           and ex.stats["submitted"]
                           == ex.stats["completed"],
                           f"sharded seed {seed} ({n_shards} shards): lane "
                           f"workers attached but never engaged cleanly "
                           f"({ex.stats})")
                    exec_stats[str(n_shards)] = dict(ex.stats)
            finally:
                mesh.close()
            for doc in docs:
                _check(mesh.quarantined(doc) == 0,
                       f"sharded seed {seed} ({n_shards} shards): "
                       f"quarantine not drained for {doc}")
            if n_shards >= 2:
                _check(mesh.stats["migrations"] >= 1,
                       f"sharded seed {seed}: no telemetry-triggered "
                       f"migration on the {n_shards}-shard mesh "
                       f"({mesh.stats}, loads "
                       f"{mesh.rebalancer.window_loads()})")
            _check_lane_tables(mesh)
            results[n_shards] = ({doc: mesh.capture(doc) for doc in docs},
                                 mesh.texts(), dict(mesh.stats))
    finally:
        if prior is None:
            os.environ.pop("AMTPU_PARALLEL_LANES", None)
        else:
            os.environ["AMTPU_PARALLEL_LANES"] = prior
    ref_shards = shard_counts[0]
    bundles0, texts0, _ = results[ref_shards]
    for n_shards, (bundles, texts, _stats) in results.items():
        _check(texts == texts0, f"sharded seed {seed}: texts diverged at "
               f"{n_shards} vs {ref_shards} shards")
        for doc in bundles0:
            _check(bundles[doc] == bundles0[doc],
                   f"sharded seed {seed}: checkpoint bytes of {doc} "
                   f"diverged at {n_shards} vs {ref_shards} shards")
    metrics = dict(
        shard_counts=list(shard_counts), n_docs=n_docs, hot_doc=hot_doc,
        **{f"stats_{n}_shards": results[n][2] for n in shard_counts},
        migrations=results[max_shards][2]["migrations"],
        parked=results[max_shards][2]["parked"],
        released=results[max_shards][2]["released"],
        lane_executor=exec_stats)
    return {"metrics": metrics,
            "captures": {d: _digest(b) for d, b in bundles0.items()},
            "texts": texts0}


def soak_residency(torch, M, device, seed: int, n_docs: int = 40,
                   n_seqs: int = 4, budget_docs: int = 4) -> dict:
    """scripts/soak.py session_residency (:1130): a population >= 10x
    the device byte budget served through the residency tier against an
    unbounded reference mesh; the peak footprint gauge stays within the
    budget after every round and every doc converges. On the card the
    record also carries the allocator's peak
    (`cuda_max_memory_allocated`, after a reset; recorded, not
    asserted)."""
    import tempfile
    dtruth = M.dt
    rng = np.random.default_rng(seed * 6133 + 11)
    docs = [f"rdoc-{seed}-{i}" for i in range(n_docs)]
    streams = {}
    for di, doc in enumerate(docs):
        actor, run_len = f"r{di}", 3
        chs = []
        for s in range(1, n_seqs + 1):
            base = (s - 1) * run_len + 1
            key = "_head" if s == 1 else f"{actor}:{base - 1}"
            ops = []
            for k in range(run_len):
                ctr = base + k
                ops.append({"action": "ins", "obj": doc, "key": key,
                            "elem": ctr})
                ops.append({"action": "set", "obj": doc,
                            "key": f"{actor}:{ctr}",
                            "value": chr(97 + (ctr + di) % 26)})
                key = f"{actor}:{ctr}"
            chs.append({"actor": actor, "seq": s, "deps": {}, "ops": ops})
        streams[doc] = chs
    pos = {d: 0 for d in docs}
    skipped: dict = {}
    rounds = []
    while True:
        pool = [d for d in docs if pos[d] < n_seqs or d in skipped]
        if not pool:
            break
        chunk = {}
        for i in rng.choice(len(pool), size=min(2, len(pool)),
                            replace=False):
            d = pool[int(i)]
            if d in skipped:
                out = [streams[d][skipped.pop(d)]]
            elif pos[d] + 1 < n_seqs and rng.random() < 0.2:
                skipped[d] = pos[d]
                out = [streams[d][pos[d] + 1]]
                pos[d] += 2
            else:
                out = [streams[d][pos[d]]]
                pos[d] += 1
            if rng.random() < 0.1:
                out = out + [out[0]]
            chunk[d] = out
        rounds.append(chunk)

    ref = _soak_mesh(torch, M, device, 2)
    for chunk in rounds:
        ref.deliver_round(chunk)
    ref_caps = {d: ref.capture(d) for d in docs}
    ref_texts = ref.texts()
    per_doc = max(doc.device_footprint()["device_bytes"]
                  for lane in ref.lanes for doc in lane.docs.values())
    ref.close()
    del ref
    budget = budget_docs * per_doc
    _check(n_docs * per_doc >= 10 * budget,
           f"residency seed {seed}: population only "
           f"{n_docs * per_doc / budget:.1f}x the budget")
    cuda = torch.device(device or "cuda").type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        allocated0 = torch.cuda.memory_allocated()
    dtruth.REGISTRY.clear_session()
    with tempfile.TemporaryDirectory() as spill:
        mesh = _soak_mesh(torch, M, device, 2)
        try:
            res = mesh.attach_residency(budget_bytes=budget,
                                        spill_dir=spill, cold_after=4)
            for n, chunk in enumerate(rounds):
                mesh.deliver_round(chunk)
                peak = dtruth.REGISTRY.footprint()["peak_device_bytes"]
                _check(peak <= budget, f"residency seed {seed}: round {n} "
                       f"peak {peak} > budget {budget}")
            for d in docs:
                _check(mesh.quarantined(d) == 0, f"residency seed {seed}: "
                       f"quarantine not drained for {d}")
            acct = res.accounting()
            population = sorted(acct["hot"] + acct["warm"] + acct["cold"])
            _check(population == sorted(docs),
                   f"residency seed {seed}: tier accounting lost docs")
            m = res.metrics()
            _check(m["budget_overruns"] == 0,
                   f"residency seed {seed}: {m['budget_overruns']} budget "
                   "overruns (working set exceeded the budget)")
            _check(m["page_outs"] > 0 and m["page_ins"] > 0, m)
            _check(m["prefetches"] > 0, f"residency seed {seed}: "
                   f"premature arrivals never prefetched a demoted doc "
                   f"({m})")
            _check(m["cold_ages"] > 0, f"residency seed {seed}: the disk "
                   f"tier never engaged ({m})")
            texts = {}
            for d in docs:
                _check(mesh.capture(d) == ref_caps[d],
                       f"residency seed {seed}: capture of {d} diverged "
                       "after paging churn")
                res.ensure_resident(d)
                lane = mesh.lane_of(d)
                with lane.device_ctx():
                    texts[d] = lane.docs[d].text()
            _check(texts == ref_texts, f"residency seed {seed}: texts "
                   "diverged after paging churn")
            fp = dtruth.REGISTRY.footprint()
            peak = fp["peak_device_bytes"]
            _check(peak <= budget, f"residency seed {seed}: paged reads "
                   f"breached the budget ({peak} > {budget})")
            _check_lane_tables(mesh)
            final = res.metrics()
        finally:
            mesh.close()
    metrics = dict(
        n_docs=n_docs, budget_bytes=budget, per_doc_bytes=per_doc,
        population_over_budget=round(n_docs * per_doc / budget, 1),
        peak_resident_bytes=final["peak_resident_bytes"],
        gauge_peak_bytes=peak, hit_rate=final["hit_rate"],
        page_in_p99_ms=final["page_in_p99_ms"],
        page_ins=final["page_ins"], page_outs=final["page_outs"],
        prefetches=final["prefetches"], cold_ages=final["cold_ages"],
        cold_loads=final["cold_loads"],
        budget_overruns=final["budget_overruns"])
    return {"metrics": metrics,
            "captures": {d: _digest(b) for d, b in ref_caps.items()},
            "texts": ref_texts,
            "cuda_max_memory_allocated": fp.get("cuda_max_memory_allocated"),
            "cuda_allocated_at_reset": allocated0 if cuda else None}


SOAK_EVENTS = ("chaos.", "chan.", "quar.", "svc.")   # what the seed fixes
SOAK_SESSIONS = {"general": soak_general, "conflict": soak_conflict,
                 "lossy": soak_lossy, "table": soak_table,
                 "chaos": soak_chaos, "checkpoint": soak_checkpoint,
                 "service": soak_service, "sharded": soak_sharded,
                 "residency": soak_residency}


def _soak_run(torch, M, device, profile: str, seed: int, **kw) -> dict:
    """One soak session on `device` from pinned uuids and zeroed
    learned-index counters (the service's on a TickClock): -> its record
    plus `wall_s` and `events`, the obs counter delta (soak.run's
    summary). Run it under obs.tracing()."""
    sync = _sync_of(torch, device)
    _pinned_uuids(M)
    M.learned.reset_stats()
    # a session is a deployment of its own: lineage off and no ledger
    # retained from an earlier phase (describe() would carry it)
    M.lineage.disable()
    M.lineage._ledger = None
    c0 = dict(M.obs.metrics_snapshot()["counters"])
    fn = SOAK_SESSIONS[profile]
    try:
        t = time.perf_counter()
        if profile == "service":
            with TickClock().installed(M.service.server):
                out = fn(torch, M, device, seed, **kw)
        else:
            out = fn(torch, M, device, seed, **kw)
        sync()
        wall = time.perf_counter() - t
    finally:
        M.uuid.reset()
    c1 = M.obs.metrics_snapshot()["counters"]
    events = {k: v - c0.get(k, 0) for k, v in sorted(c1.items())
              if v - c0.get(k, 0) > 0}
    return dict(out, wall_s=wall, events=events)


def _soak_state(rec: dict) -> dict:
    """What a card run must share with its CPU run: the session's record
    less wall-clock readings, the allocator's, the scrape counts (the
    card's page carries device families) and the events the seed does
    not fix (device dispatches and syncs)."""
    out = {k: v for k, v in rec.items()
           if k not in ("wall_s", "events", "cuda_max_memory_allocated",
                        "cuda_allocated_at_reset")}
    out["events"] = {k: v for k, v in rec["events"].items()
                     if k.startswith(SOAK_EVENTS)}
    if "metrics" in out:
        out["metrics"] = {k: v for k, v in out["metrics"].items()
                          if not k.startswith("scrape_")}
    return _nt(out)


def soak_twin(torch, M, profile: str, seed: int, **kw) -> tuple:
    """A soak session's CPU run: (its `_soak_state`, its seconds)."""
    with M.obs.tracing():
        rec = _soak_run(torch, M, "cpu", profile, seed, **kw)
    return _soak_state(rec), rec["wall_s"]


_TWIN: dict = {}


def _twin_init():
    """A CpuTwins worker's start: this script's port namespace, on three
    intra-op threads (two workers and the card's host thread share the
    card machine's eight cores)."""
    import torch
    torch.set_num_threads(3)
    _TWIN.update(torch=torch, M=port_modules())


def _twin_call(name: str, args, kw, item):
    out = globals()[name](_TWIN["torch"], _TWIN["M"], *args, **kw)
    return out if item is None else out[item]


class CpuTwins:
    """Two spawned worker processes for the CPU runs the card's phases
    are held to: they go on there while this process drives the card,
    and never touch it. `submit(name, *args, item=None, **kw)` runs this
    script's top-level function name(torch, M, *args, **kw) in a free
    worker and returns a future of its result (of `result[item]` when
    `item` is given). A worker imports this script by its module name
    from the path it inherits. Leaving the `with` block stops them."""

    def __init__(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        self._pool = ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn"),
            initializer=_twin_init)

    def submit(self, name: str, *args, item=None, **kw):
        return self._pool.submit(_twin_call, name, args, kw, item)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._pool.shutdown(wait=True, cancel_futures=True)


def soak_phase(torch, M, card: str, device=None, seeds=SOAK_SEEDS,
               clients: int = SOAK_CLIENTS,
               client_ticks: int = SOAK_CLIENT_TICKS, twins=None) -> dict:
    """Phase 19: scripts/soak.py's sessions other than federation on
    `device`, at the soak's defaults for every seed in `seeds`, plus one
    service session of `clients` tenants over `client_ticks` ticks
    (`--service --clients 1000`) serving its scrape endpoint, and the
    sharded session's 8-shard leg again with AMTPU_PARALLEL_LANES=1. On
    the card every session's CPU run goes to `twins` (a CpuTwins) before
    the card's runs start, and each card session must end in its CPU
    run's state (`_soak_state`). Raises on the first failure. The kernel
    counts are set to 0 before each card session and read after it."""
    cuda = torch.device(device or "cuda").type == "cuda"
    count, launches, shapes, by_part = part_counts(
        M, _sync_of(torch, device))
    specs = [(f"{p}/{s}", p, s, {}) for p in SOAK_SESSIONS for s in seeds]
    specs.append((f"service/0@{clients}", "service", 0,
                  {"n_clients": clients, "n_ticks": client_ticks}))
    wants = {part: twins.submit("soak_twin", p, s, **kw)
             for part, p, s, kw in specs} if cuda else {}
    t_phase = time.perf_counter()
    out = {"seeds": list(seeds), "clients": clients, "sessions": {}}
    with M.obs.tracing():
        for part, profile, seed, kw in specs:
            card_kw = dict(kw, scrape=True) if "n_clients" in kw else kw
            rec = count(part, lambda: _soak_run(torch, M, device, profile,
                                                seed, **card_kw))
            want, cpu_s = wants[part].result() if cuda else (
                _soak_state(rec), None)
            if _soak_state(rec) != want:
                raise AssertionError(f"19 {part}: the card's final state "
                                     "differs from the CPU run's")
            row = {"wall_s": rec["wall_s"], "cpu_s": cpu_s,
                   "events": rec["events"], "launches": by_part[part]}
            m = rec.get("metrics", {})
            if profile == "service":
                row.update({k: m[k] for k in (
                    "n_clients", "killed", "rejoined", "orphan_rejoins",
                    "evictions", "shed_total", "deferrals",
                    "max_starved_streak", "peak_inbox")},
                    scrape={k: v for k, v in m.items()
                            if k.startswith("scrape_")})
            if profile == "sharded":
                row["migrations"] = m["migrations"]
                workers = count(f"{part}+workers", lambda: _soak_run(
                    torch, M, device, profile, seed, shard_counts=(8,),
                    parallel_lanes="1"))
                if (workers["captures"], workers["texts"]) != (
                        rec["captures"], rec["texts"]):
                    raise AssertionError(f"19 {part}: the 8-shard leg "
                                         "with lane workers differs")
                row["workers"] = {"wall_s": workers["wall_s"],
                                  "lane_executor": workers["metrics"][
                                      "lane_executor"],
                                  "launches": by_part[f"{part}+workers"]}
            if profile == "residency":
                row.update(budget_bytes=m["budget_bytes"],
                           peak_device_bytes=m["gauge_peak_bytes"],
                           cuda_max_memory_allocated=rec[
                               "cuda_max_memory_allocated"],
                           cuda_allocated_at_reset=rec[
                               "cuda_allocated_at_reset"],
                           page_ins=m["page_ins"], page_outs=m["page_outs"],
                           hit_rate=m["hit_rate"])
            out["sessions"][part] = row
            log(f"19 {part} ({card}): {rec['wall_s']:.2f} s (CPU run "
                f"{cpu_s} s), equal to the CPU run; launches "
                f"{by_part[part]}; events {rec['events']}")
    if cuda and not launches["multi_scan"]:
        raise AssertionError(f"19: multi_scan missed the soak: {launches}")
    out.update(launches=launches, shapes=shapes,
               wall_s=time.perf_counter() - t_phase)
    log(f"soak phase launches: {launches}; phase {out['wall_s']:.2f} s "
        f"({card})")
    log("soak record: " + json.dumps(dict(out, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in shapes.items()})))
    return out


# --- the cold text-planning population (bench.py cfg12t / cfg19) -----------

PLAN_DOCS = 512                # 20: bench.py measure_text_prepare (cfg12t)
PLAN_CAP = 1024                # and measure_learned_index (cfg19): 512 text
PLAN_SEED_OPS = 64             # docs at capacity 1,024, a 64-op seed round,
PLAN_ROUNDS = 8                # then 2 warm-up and 5 timed streams of 8
PLAN_OPS = 8                   # rounds of 8 ops a doc
PLAN_WARMUP = 2
PLAN_REPS = 5
PLAN_TERMS = ("detect_runs", "index_merge", "rank_resolve", "admission",
              "cross_doc")


def plan_streams(doc_ids, n_rounds: int, ops: int, n_streams: int) -> list:
    """bench.py measure_text_prepare's streams after its seed round:
    stream r is n_rounds rounds of `_sharded_text_round`, each appending
    an ops-op run to every doc."""
    streams = []
    for rep in range(n_streams):
        seq0 = 2 + rep * n_rounds
        base = 33 + (seq0 - 2) * (ops // 2)
        streams.append([stack_text_round(doc_ids, seq0 + r,
                                         base + (ops // 2) * r, ops)
                        for r in range(n_rounds)])
    return streams


def _plan_terms(M) -> dict:
    aggs = M.obs.telemetry().span_aggregates()
    return {name: aggs.get(("plan", name), {}).get("total_ns", 0)
            for name in PLAN_TERMS}


def plan_run(torch, M, device, n_docs: int = PLAN_DOCS,
             n_rounds: int = PLAN_ROUNDS, ops: int = PLAN_OPS,
             warmup: int = PLAN_WARMUP, reps: int = PLAN_REPS,
             profile: bool = False) -> dict:
    """cfg12t's cross_doc leg (cfg19's production leg) on `device`: the
    seed round, then warmup + reps streams through `apply_stacked`, each
    round stacked within its budget, each stream timed to a sync and its
    garbage collection held off. Returns the admitted ops/s of the timed
    streams, the stacked counters, the plan span terms over every stream,
    the learned sites' statistics and the final texts. With `profile`,
    one more stream runs under torch.profiler after the texts are read
    (its busy share)."""
    import gc
    sync = _sync_of(torch, device)
    doc_ids = [f"tp-{i:05d}" for i in range(n_docs)]
    M.learned.reset_stats()
    docs = {d: M.DeviceTextDoc(d, capacity=PLAN_CAP, device=device)
            for d in doc_ids}
    seed = stack_text_round(doc_ids, 1, 1, PLAN_SEED_OPS)
    st = M.stacked.apply_stacked([(docs[k], v) for k, v in seed.items()])
    _check(st, "20: the seed round fell off the stacked path")
    streams = plan_streams(doc_ids, n_rounds, ops,
                           warmup + reps + int(profile))
    rates, merges, plans, shared = [], 0, 0, 0
    terms0 = _plan_terms(M)

    def stream(rounds):
        nonlocal merges, plans, shared
        admitted = 0
        for chunk in rounds:
            st = M.stacked.apply_stacked([(docs[k], v)
                                          for k, v in chunk.items()])
            _check(st, "20: a round fell off the stacked path")
            M.stacked.assert_round_budget(st)
            merges += st["index_merges"]
            plans += st["text_plans"]
            shared += (st.get("cross_doc") or {}).get("sched_shared", 0)
            admitted += sum(len(c["ops"]) for v in chunk.values()
                            for c in v)
        sync()
        return admitted

    gc_was = gc.isenabled()
    try:
        for rounds in streams[:warmup + reps]:
            gc.collect()
            gc.disable()
            t0 = time.perf_counter()
            admitted = stream(rounds)
            rates.append(admitted / (time.perf_counter() - t0))
            if gc_was:
                gc.enable()
    finally:
        if gc_was:
            gc.enable()
    terms = {k: (v - terms0[k]) / 1e9 for k, v in _plan_terms(M).items()}
    sites = M.learned.stats_snapshot()
    texts = {k: d.text() for k, d in docs.items()}
    out = {"ops_per_s": rates[warmup:], "index_merges": merges,
           "text_plans": plans, "sched_shared": shared,
           "plan_terms_s": terms, "sites": sites,
           "texts_sha256": _digest(json.dumps(texts, sort_keys=True)
                                   .encode())}
    if profile:
        wall, dev_us, n_ops, _, _ = _profiled(
            torch, True, lambda: stream(streams[-1]))
        out["profile"] = {"wall_s": wall, "device_s": dev_us / 1e6,
                          "device_ops": n_ops,
                          "busy_share": dev_us / 1e6 / wall}
    return out


def plan_twin(torch, M, **sizes) -> dict:
    """Phase 20's CPU run: what the card's run must share with it, and
    its seconds."""
    t = time.perf_counter()
    with M.obs.tracing():
        rec = plan_run(torch, M, "cpu", **sizes)
    return dict({k: rec[k] for k in ("texts_sha256", "index_merges",
                                     "text_plans", "sched_shared")},
                cpu_s=time.perf_counter() - t)


def plan_phase(torch, M, card: str, device=None, profile: bool = False,
               cpu_run=None, **sizes) -> dict:
    """Phase 20: bench.py cfg12t/cfg19's 512-document cold planning
    population on `device` (`plan_run`), with bench.py's in-run checks
    (every apply stacked within its budget, one index merge per planned
    text round, a shared cross-doc schedule) and cfg19's that the port
    can make (the cross_doc_seed and range_index sites verified model
    joins, no site demoted). On the card `cpu_run` is the future of the
    same stream's CPU run (`plan_twin`, submitted to a CpuTwins before
    phase 19 so that it runs beside that phase), whose final texts and
    stacked counters the card's must equal. The kernel counts are set to
    0 before the card's run and read after it."""
    cuda = torch.device(device or "cuda").type == "cuda"
    count, launches, shapes, _ = part_counts(M, _sync_of(torch, device))
    t_phase = time.perf_counter()
    with M.obs.tracing():
        rec = count("20", lambda: plan_run(torch, M, device,
                                           profile=profile, **sizes))
    _check(rec["index_merges"] == rec["text_plans"],
           f"20: {rec['index_merges']} index merges for "
           f"{rec['text_plans']} planned text rounds")
    _check(rec["sched_shared"] > 0,
           "20: the cross-doc planner never shared a schedule")
    for site in ("cross_doc_seed", "range_index"):
        _check(rec["sites"][site]["hits"] > 0,
               f"20: the learned site {site} never engaged: {rec['sites']}")
    demotions = sum(v["demotions"] for v in rec["sites"].values())
    _check(demotions == 0, f"20: a learned site demoted: {rec['sites']}")
    if cuda:
        _check(launches["multi_scan"] > 0,
               f"20: multi_scan missed the stacked rounds: {launches}")
        want = cpu_run.result()
        rec["cpu_s"] = want["cpu_s"]
        _check(want["texts_sha256"] == rec["texts_sha256"],
               "20: the card's texts differ from the CPU run's")
        _check((want["index_merges"], want["text_plans"],
                want["sched_shared"]) == (rec["index_merges"],
                                          rec["text_plans"],
                                          rec["sched_shared"]),
               "20: the card's stacked counters differ from the CPU run's")
    rates = rec["ops_per_s"]
    rec.update(launches=launches, shapes=shapes,
               ops_per_s_spread=_spread(rates),
               wall_s=time.perf_counter() - t_phase)
    log(f"20 cold planning ({card}): {len(rates)} timed streams, admitted "
        f"ops/s median {rec['ops_per_s_spread']['median']:.0f} "
        f"({min(rates):.0f}-{max(rates):.0f}); {rec['text_plans']} "
        f"planned text rounds, {rec['index_merges']} index merges; plan "
        f"terms {rec['plan_terms_s']}; launches {launches}; phase "
        f"{rec['wall_s']:.2f} s")
    log("plan record: " + json.dumps(dict(rec, shapes={
        k: {"x".join(map(str, sh)): n for sh, n in v.items()}
        for k, v in shapes.items()})))
    return rec


def _sharded_library(torch, chain, has, ne, n: int):
    """One PyTorch program's form of the sharded scans: per shard the
    library scans (`torch.cumsum` x 2, `torch.cummax`) on its precomputed
    starts, candidates and visibility, then the earlier shards' totals
    added (and maxed) in."""
    C = chain.shape[-1]
    w = C // n
    flat = torch.arange(C, dtype=torch.int32, device=chain.device)
    lim = ne[:, None] if torch.is_tensor(ne) and ne.dim() == 1 else ne
    is_elem = (flat >= 1) & (flat <= lim)
    ss = (is_elem & ~chain).to(torch.int32)
    cand = torch.where(ss > 0, flat, 0)
    vis = (is_elem & has).to(torch.int32)
    parts = [(ss[..., i * w:(i + 1) * w], cand[..., i * w:(i + 1) * w],
              vis[..., i * w:(i + 1) * w]) for i in range(n)]

    def library():
        carry = None
        for s, c, v in parts:
            r = torch.cumsum(s, -1, dtype=torch.int32)
            h = torch.cummax(c, -1).values
            cv = torch.cumsum(v, -1, dtype=torch.int32)
            if carry is not None:
                r, h, cv = (r + carry[0], torch.maximum(h, carry[1]),
                            cv + carry[2])
            carry = (r[..., -1:], h[..., -1:], cv[..., -1:])
    return library


def _totals_library(torch, chain, has, ne, n: int):
    """One PyTorch program's form of the per-shard totals: sums and a max
    of each shard's precomputed starts, candidates and visibility."""
    C = chain.shape[-1]
    w = C // n
    flat = torch.arange(C, dtype=torch.int32, device=chain.device)
    lim = ne[:, None] if torch.is_tensor(ne) and ne.dim() == 1 else ne
    is_elem = (flat >= 1) & (flat <= lim)
    ss = (is_elem & ~chain).to(torch.int32)
    cand = torch.where(ss > 0, flat, 0)
    vis = (is_elem & has).to(torch.int32)

    def library():
        for i in range(n):
            sl = slice(i * w, (i + 1) * w)
            torch.stack([ss[..., sl].sum(-1, dtype=torch.int32),
                         cand[..., sl].amax(-1),
                         vis[..., sl].sum(-1, dtype=torch.int32)], -1)
    return library


def time_sharded(torch, M, configs) -> dict:
    """Phase 7 for the kernel pair: at each (shape, (doc, elem) mesh) the
    mesh path ran or 15(a) checked, the device time of the whole sharded
    form (`fs_totals` a shard, the all_gather, a carry-in `fs_scan` a
    shard), of `fs_totals` alone over the shards, of the unsharded
    kernel on the same column, of the plain versions and of the library
    compositions, with the bounds. Returns {kernel name: [records]}."""
    S, pm = M.S, M.pmesh
    dev = torch.device("cuda")
    rng = np.random.default_rng(77)
    out = {"sharded_fused_scans": [], "fs_totals": []}
    for shape, grid in configs:
        n_rows = shape[0] if len(shape) == 2 else 1
        C = shape[-1]
        mesh = _virtual(M, dev, grid[0] * grid[1], grid[0])
        n = grid[1]
        w = C // n
        pairs = fs_copies(torch, rng, shape, dev)
        if len(shape) == 2:
            ne = torch.from_numpy(rng.integers(
                C // 2, C + 1, n_rows).astype(np.int32)).to(dev)
            ne_s = pm.shard(mesh, ne, ("doc",))
        else:
            ne = ne_s = C - C // 20
        spec = ("doc", "elem") if len(shape) == 2 else ("elem",)
        sharded = [(pm.shard(mesh, c, spec), pm.shard(mesh, h, spec))
                   for c, h in pairs]
        kern = [lambda c=c, h=h: S.sharded_fused_scans(mesh, c, h, ne_s)
                for c, h in sharded]
        whole = [lambda c=c, h=h: S.fused_segment_scans(c, h, ne)
                 for c, h in pairs]
        c0, h0 = pairs[0]
        plain = lambda: S.sharded_fused_scans_plain(c0, h0, ne, n)  # noqa
        got = [x.gather(dev) for x in kern[0]()]
        want = S.sharded_fused_scans_plain(c0, h0, ne, n)
        err = max(int((g - x).abs().max()) for g, x in zip(got, want))

        def totals(c, h):
            return lambda: [S.fs_totals(c.blocks[k], h.blocks[k],
                                        ne_s.blocks[k] if len(shape) == 2
                                        else ne, k[1] * w)
                            for k in mesh.coords()]

        def totals_plain():
            return [S.fs_totals_plain(c0[..., i * w:(i + 1) * w],
                                      h0[..., i * w:(i + 1) * w], ne, i * w)
                    for i in range(n)]
        t_err = max(int((S.fs_totals(c0[..., i * w:(i + 1) * w].contiguous(),
                                     h0[..., i * w:(i + 1) * w].contiguous(),
                                     ne, i * w) - t).abs().max())
                    for i, t in enumerate(totals_plain()))
        slots = int(np.prod(shape))
        b_ms, b_by = _fs_bound(shape)
        ex_bytes = 12 * n_rows * n * (n - 1)
        shard_shape = ((shape[0] // grid[0], w) if len(shape) == 2
                       else (w,))
        rec = {"shape": list(shape), "mesh": list(grid), "copies": len(pairs),
               "shard_shape": list(shard_shape),
               "form": fs_form(S, shard_shape), "max_abs_err": err,
               "ms": time_ms(torch, kern),
               "unsharded_ms": time_ms(torch, whole),
               "plain_ms": time_ms(torch, [plain], reps=5),
               "library_ms": time_ms(torch, [_sharded_library(
                   torch, c0, h0, ne, n)], reps=5),
               "bound_ms": b_ms + ex_bytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": b_by, "exchange_bytes": ex_bytes,
               "read_write_bytes": 16 * slots + 12 * n_rows * n * n}
        out["sharded_fused_scans"].append(rec)
        tb_ms, tb_by = bound(2 * slots + 16 * n_rows * n, 3 * slots)
        out["fs_totals"].append({
            "shape": list(shape), "mesh": list(grid), "copies": len(pairs),
            "shard_shape": list(shard_shape),
            "form": fs_form(S, shard_shape), "max_abs_err": t_err,
            "ms": time_ms(torch, [totals(c, h) for c, h in sharded]),
            "plain_ms": time_ms(torch, [totals_plain], reps=5),
            "library_ms": time_ms(torch, [_totals_library(
                torch, c0, h0, ne, n)], reps=5),
            "bound_ms": tb_ms, "bound_by": tb_by})
        del pairs, sharded, kern, whole
    for name, recs in out.items():
        for r in recs:
            if r["max_abs_err"] != 0:
                raise AssertionError(f"{name} {r['shape']} over {r['mesh']} "
                                     f"differs from plain")
            r["bound_frac"] = r["bound_ms"] / r["ms"]
            log(f"{name} {r['shape']} over mesh {r['mesh']} (shards "
                f"{r['shard_shape']}, {r['form']} form): kernel "
                f"{r['ms']:.4f} ms ({100 * r['bound_frac']:.1f}% of bound"
                + (f", unsharded kernel {r['unsharded_ms']:.4f} ms"
                   if "unsharded_ms" in r else "")
                + f"), plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']})")
    return out


def _device_spans(torch, prof) -> list:
    """(name, start us, duration us) of every device event of a profile,
    in start order."""
    ev = [(e.name, e.time_range.start, e.time_range.end - e.time_range.start)
          for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(ev, key=lambda x: x[1])


def _span_summary(spans) -> dict:
    """A call's device events: their span from the first start to the last
    end, the summed durations (over the span: how much they overlapped),
    and count and mean duration by kernel."""
    if not spans:
        return {"span_us": 0.0, "busy_us": 0.0, "by_kernel": {}}
    t0 = spans[0][1]
    end = max(s + d for _, s, d in spans)
    by = {}
    for name, _, d in spans:
        key = (name.replace("void ", "").replace("(anonymous namespace)::", "")
               .split("(")[0][:40])
        n, tot = by.get(key, (0, 0.0))
        by[key] = (n + 1, tot + d)
    return {"span_us": end - t0, "busy_us": sum(d for _, _, d in spans),
            "by_kernel": {k: {"n": n, "mean_us": tot / n}
                          for k, (n, tot) in by.items()}}


def scan_profile(torch, M, out_dir: str, calls: int = 3) -> dict:
    """`--scan-profile DIR`: the segment scans alone. First phase 7's
    device times of `fused_segment_scans` at the driven shapes of PERF.md
    §6 and of the sharded pair (with `fs_totals` alone) at its shapes;
    then the pair under torch.profiler, eager (`calls` calls after
    warm-ups, each alone on the card) and as one replay of a captured
    graph of `calls` calls: the device span of a call, its device
    operations' summed time (their overlap) and each one's mean duration,
    the unsharded kernel beside it. Writes the traces to DIR."""
    times = time_kernels(torch, M.S, [], [
        (256,), (131_072,), (DOCSET_DOCS, 768), (1_048_576,), (N_MERGE,)],
        lambda sh: (sh[0] - sh[0] // 16 if len(sh) == 1
                    else [sh[1] - 1] * sh[0]))
    sharded = time_sharded(torch, M, [
        ((8 * 1_048_576,), (1, 8)), ((8 * 1_048_576,), (1, 2)),
        ((DOCSET_DOCS, 768), MESH_DOCSET), ((4, 384), (2, 4))])
    from torch.profiler import ProfilerActivity, profile
    S, pm = M.S, M.pmesh
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for shape, grid in (((8 * 1_048_576,), (1, 8)), ((DOCSET_DOCS, 768),
                                                      MESH_DOCSET),
                        ((4, 384), (2, 4))):
        mesh = _virtual(M, dev, grid[0] * grid[1], grid[0])
        c, h = fs_copies(torch, rng, shape, dev)[0]
        if len(shape) == 2:
            ne = torch.full(shape[:1], shape[1] - 3, dtype=torch.int32,
                            device=dev)
            ne_s = pm.shard(mesh, ne, ("doc",))
            spec = ("doc", "elem")
        else:
            ne = ne_s = shape[0] - shape[0] // 20
            spec = ("elem",)
        cs, hs = pm.shard(mesh, c, spec), pm.shard(mesh, h, spec)
        label = "x".join(map(str, shape)) + f" over {grid}"
        rec = {}
        for name, fn in (
                ("pair", lambda: S.sharded_fused_scans(mesh, cs, hs, ne_s)),
                ("unsharded", lambda: S.fused_segment_scans(c, h, ne))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            eager = []
            for _ in range(calls):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                eager.append(_span_summary(_device_spans(torch, prof)))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                for _ in range(calls):
                    fn()
            graph.replay()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                graph.replay()
                torch.cuda.synchronize()
            spans = _device_spans(torch, prof)
            prof.export_chrome_trace(os.path.join(
                out_dir, f"scan_{name}_{label.replace(' ', '_')}.json"))
            rec[name] = {"eager": eager, "graph": dict(
                _span_summary(spans), calls=calls)}
            del graph
            log(f"scan profile {label} {name}: eager span "
                f"{[round(e['span_us'], 2) for e in eager]} us, busy "
                f"{[round(e['busy_us'], 2) for e in eager]} us; graph of "
                f"{calls}: span {rec[name]['graph']['span_us']:.2f} us, busy "
                f"{rec[name]['graph']['busy_us']:.2f} us, by kernel "
                f"{json.dumps(rec[name]['graph']['by_kernel'])}")
        out[label] = rec
    return {"times": times, "sharded": sharded, "profile": out}


def wrapper_host_main(torch, root: str) -> int:
    """`--wrapper-host ROOT`: build ROOT's scan kernels and print the host
    microseconds per call of its scan wrappers (wrapper_host_us), the
    card, and one JSON line."""
    sys.path.insert(0, root)
    try:
        from automerge_tpu_torch.ops import scan_kernels as S
    except ImportError as e:
        print(f"chip_smoke: no port package under {root}: {e}",
              file=sys.stderr)
        return 2
    if not S.__file__.startswith(root):
        raise AssertionError(f"imported {S.__file__}, not {root}'s")
    S.build()
    rec = {"root": root, "host_us": wrapper_host_us(torch, S)}
    print(nvidia_smi_line(), flush=True)
    print(json.dumps(rec), flush=True)
    return 0


def port_modules():
    """The port's modules the phases drive (ImportError when the package
    is not beside this script)."""
    from types import SimpleNamespace

    import automerge_tpu_torch as am
    from automerge_tpu_torch import (_common, _uuid, checkpoint, federation,
                                     native, obs, residency, resilience,
                                     service, shard)
    from automerge_tpu_torch.backend import device as device_backend
    from automerge_tpu_torch.engine import (DeviceMapDoc, DeviceTextDocSet,
                                            MapChangeBatch,
                                            PipelinedIngestor, accounting,
                                            runs, stacked)
    from automerge_tpu_torch.engine import learned_index
    from automerge_tpu_torch.engine.columnar import TextChangeBatch
    from automerge_tpu_torch.engine.text_doc import DeviceTextDoc
    from automerge_tpu_torch.obs import device_truth, export, lineage, prom
    from automerge_tpu_torch.ops import scan_kernels
    from automerge_tpu_torch.ops.ingest import bucket
    from automerge_tpu_torch.parallel import _dryrun
    from automerge_tpu_torch.parallel import mesh as pmesh
    from automerge_tpu_torch.shard import audit
    from automerge_tpu_torch.shard import parallel as lanes
    return SimpleNamespace(
        C=_common, native=native, obs=obs, ckpt=checkpoint, uuid=_uuid,
        dt=device_truth, export=export, lineage=lineage, prom=prom,
        DeviceMapDoc=DeviceMapDoc,
        MapChangeBatch=MapChangeBatch, PipelinedIngestor=PipelinedIngestor,
        accounting=accounting, runs=runs, TB=TextChangeBatch,
        DeviceTextDoc=DeviceTextDoc, DeviceTextDocSet=DeviceTextDocSet,
        stacked=stacked, S=scan_kernels, bucket=bucket, am=am,
        device_backend=device_backend, shard=shard, residency=residency,
        pmesh=pmesh, dryrun=_dryrun, audit=audit, service=service,
        federation=federation, res=resilience, lanes=lanes,
        learned=learned_index)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile the headline commit of both "
                         "materialization paths and the multi-document "
                         "tier; traces go to DIR")
    ap.add_argument("--lane-probe", action="store_true",
                    help="run only the lane-worker probe (lane_probe) "
                         "and print its record as the last line")
    ap.add_argument("--blocking-sync", action="store_true",
                    help="host waits on the card block instead of spin "
                         "(set before the CUDA context is made)")
    ap.add_argument("--scan-profile", metavar="DIR", default=None,
                    help="only profile the sharded segment scans at phase "
                         "7's shapes (eager and in a graph), writing the "
                         "traces to DIR, and print the record last")
    ap.add_argument("--workloads", action="store_true",
                    help="only build the kernels and run phase 18 (the "
                         "JAX package's remaining workloads), printing "
                         "its record as the last line")
    ap.add_argument("--soak", action="store_true",
                    help="only build the kernels and run phases 19-20 (the "
                         "soak campaign and the cold planning population), "
                         "printing their record as the last line")
    ap.add_argument("--wrapper-host", metavar="ROOT", default=None,
                    help="only time the host work per call of the "
                         "scan wrappers of the package under ROOT "
                         "(this checkout's or another's) and print it as "
                         "the last line")
    args = ap.parse_args()
    if os.environ.get("PYTHONHASHSEED") != "0":
        # one string-hash order for this process and the CpuTwins worker
        # it spawns: the order of the sync hub's sets reaches a service
        # session's schedule, so the card's runs and their CPU runs must
        # iterate them alike
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    ctx_flags = blocking_sync() if args.blocking_sync else None
    here = os.path.dirname(os.path.abspath(__file__))
    if args.wrapper_host:
        return wrapper_host_main(torch, os.path.abspath(args.wrapper_host))
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
    if args.scan_profile:
        S.build()
        rec = scan_profile(torch, M, args.scan_profile)
        print(card, flush=True)
        print(json.dumps(rec), flush=True)
        return 0
    if args.lane_probe:
        with ThreadPoolExecutor(2) as ex:
            native_build = ex.submit(M.native.load)
            S.build()
            native_build.result()
        rec = dict(lane_probe(torch, M, card), context_flags=ctx_flags)
        print(card, flush=True)
        print(json.dumps(rec), flush=True)
        return 0
    if args.workloads:
        with ThreadPoolExecutor(2) as ex:
            native_build = ex.submit(M.native.load)
            S.build()
            native_build.result()
        rec = adv_phase(torch, M, card)
        rec["profile_18a"] = profile_residual(torch, M)
        print(card, flush=True)
        print(json.dumps({k: v for k, v in rec.items() if k != "shapes"}),
              flush=True)
        return 0
    if args.soak:
        with ThreadPoolExecutor(2) as ex:
            native_build = ex.submit(M.native.load)
            S.build()
            native_build.result()
        with CpuTwins() as twins:
            plan_cpu = twins.submit("plan_twin")
            rec = {"soak": soak_phase(torch, M, card, twins=twins),
                   "plan": plan_phase(torch, M, card, cpu_run=plan_cpu,
                                      profile=bool(args.profile))}
        print(card, flush=True)
        print(json.dumps({p: {k: v for k, v in r.items() if k != "shapes"}
                          for p, r in rec.items()}), flush=True)
        return 0

    # 2. build: the CUDA kernels (nvcc) and the host codec (g++), started
    # together
    t_run = time.perf_counter()
    ends = {}

    def phase_done(label):
        ends[label] = round(time.perf_counter() - t_run, 1)
        log(f"phase {label} done {ends[label]} s into the run")

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

    phase_done("2")

    # 3. kernels vs plain, and one eager call of each at the merge shapes
    # (the device-time readings, by CUDA graphs, come after the paths)
    check_kernels(torch, S)
    eager = time_eager_merge(torch, S)
    n_expect = BASE_LEN + N_ACTORS * (OPS_PER_CHANGE // 2)

    phase_done("3")

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

    # 6. residual rounds and the pull
    before = dict(accounting.LABELS["dispatch"].get("fused_mixed_round",
                                                    {"n": 0}))
    S.reset_launches()
    doc.apply_changes(residual_changes(BASE_LEN))
    res_launches = dict(S.launches)
    res_shapes = {k: dict(v) for k, v in S.launch_shapes.items()}
    cpu_doc.apply_changes(residual_changes(BASE_LEN))
    mixed = (accounting.LABELS["dispatch"]["fused_mixed_round"]["n"]
             - before["n"])
    pulled = doc.text()
    pull_stats = dict(doc.pull_stats)
    # a fresh document restored from the merged tables rebuilds its
    # segment mirror from the chain bits
    fresh = M.ckpt.restore_engine(M.ckpt.capture_engine(doc)).text()
    cpu_text = cpu_doc.text()
    log(f"residual round: fused_mixed_round dispatches {mixed}, launches "
        f"{res_launches}, pull {pull_stats}, conflicts "
        f"{len(doc.conflicts)}")
    if mixed < 1 or res_launches["multi_scan"] < 1:
        raise AssertionError("the residual round missed the mixed round")
    if pull_stats.get("mode") != "full":
        raise AssertionError(f"pull was not full: {pull_stats}")
    if not (pulled == fresh == cpu_text):
        raise AssertionError("the pull differs from a fresh document's")
    if len(pulled) != n_expect + 2 - 5 or not doc.conflicts:
        raise AssertionError("residual round result is wrong")
    if any("diverged" in m for m in heals.records):
        raise AssertionError(f"segment mirror healed: {heals.records}")
    del doc, cpu_doc

    phase_done("4-6")

    # 6a. the streaming ring: bench.py --pipeline's stream at full width
    ring = ring_phase(torch, M, card)
    if any("diverged" in m for m in heals.records):
        raise AssertionError(f"segment mirror healed: {heals.records}")

    phase_done("6a")

    # 6b. a 1,000,000-key map document: fast-path and slow-path rounds
    map_phase(torch, M, card)

    phase_done("6b")

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

    phase_done("8")

    # 9. the public API on the card (before phase 7 too): api-a cfg4's
    # trellis merge at 1,000 actors, api-b cfg7's interactive latency on a
    # 100,000-char text, api-c one graduation
    api = api_phase(torch, M, card)
    stacked_shapes = {k: {sh: st_a["shapes"][k].get(sh, 0)
                          + st_b["shapes"][k].get(sh, 0)
                          for sh in set(st_a["shapes"][k])
                          | set(st_b["shapes"][k])} for k in S.launches}

    phase_done("9")

    # 12. the checkpoint tier (before phase 7 too): the engine cold start
    # at bench.py measure_restore's sizes under obs.tracing(), the API's
    # checkpoint forms on api-b's document, the cfg5f ring under captures
    ckpt = ckpt_phase(torch, M, card,
                      out_dir=os.path.join(here, "chiprun_out"))

    phase_done("12")

    # the CPU runs of phases 13, 16, 17, 19 and 20 go on in two worker
    # processes while this one drives the card
    with CpuTwins() as twins:
        # 13. the sync tier (before phase 7 too): sync-a cfg9's fan-out to 20
        # peers on cfg7's text, a reconnect and a late full-history join;
        # sync-b a 20-peer join storm served from one snapshot; sync-c two
        # replicas under cross-region WAN chaos
        sync = sync_phase(torch, M, card, twins=twins)

        phase_done("13")

        # 14. the sharded serving tier (before phase 7 too): shard-a cfg12's
        # 5,120 map and 512 text docs on 8 lanes (streams) of the card, with
        # the workers, sequentially and on one lane; shard-b the router's
        # park/drain, a forced and a rebalancer migration; shard-c cfg18
        # through the pager
        shard_rec = shard_phase(torch, M, card)

        phase_done("14")

        # 15. the mesh path (before phase 7 too): 15a the kernel pair checked
        # over virtual shards of the card, 15b the headline document (phase
        # 5's) materialized elem-sharded over 8 shards, 15c the cfg3 DocSet on
        # a (2, 4) mesh and on the cards, 15d the dry run and the audit
        mesh_rec = mesh_phase(torch, M, card, doc2, sha(r["text"]))
        del doc2

        phase_done("15")

        # 7 (first part). one kernel per call, before phases 16-17: after 16a's
        # population a profiler session loses device events (it saw no activity
        # at all for an fs_totals call that ran), and after phase 7's CUDA
        # graph replays too; a session left behind slows later host launches,
        # which phase 15's ten sessions already do
        per_call = check_kernels_per_call(torch, S)

        phase_done("7a")

        # 16. the service tier (before phase 7 too): 16a cfg11 at its defaults,
        # 16b the same service on rooms of cfg7's text, 16c 16a on 8 lanes
        # (streams) with the pager, sequential and pipelined ticks, 16d the
        # loopback scrape endpoint
        svc_rec = svc_phase(torch, M, card, twins=twins)

        phase_done("16")

        # 17. the federation (before phase 7 too): scripts/soak.py
        # session_federation at its defaults, every region's rooms on the card
        fed_rec = fed_phase(torch, M, card, twins=twins)

        phase_done("17")

        # 18. the JAX package's remaining workloads (before phase 7 too): 18a
        # cfg5b residual-heavy and 18b cfg5c two causal rounds at the
        # headline's width, 18c cfg6 conflict-heavy, 18d cfg2's shared counter,
        # 18e cfg10 save/load, 18f cfg7b nested edits under a 100,000-key root;
        # each against a CPU run
        adv_rec = adv_phase(torch, M, card, clean_commit_s=r["commit_s"])

        phase_done("18")

        # 19. the soak campaign (before phase 7 too): scripts/soak.py's nine
        # sessions other than federation at seeds 0-2 and a 1,000-client
        # service session, each against the same seed on the CPU; phase
        # 20's CPU run goes to a worker now and runs beside it
        plan_cpu = twins.submit("plan_twin")
        soak_rec = soak_phase(torch, M, card, twins=twins)

        phase_done("19")

        # 20. the cold text-planning population (before phase 7 too): bench.py
        # cfg12t/cfg19's 512 documents through the cross-doc planner, the batch
        # index and the learned index, against a CPU run
        plan_rec = plan_phase(torch, M, card, cpu_run=plan_cpu,
                              profile=bool(args.profile))

    phase_done("20")

    # 7. kernel times at every shape the driven paths launched with
    shapes_by_path = {"main": main_shapes, "self_contained": sc_shapes,
                      "residual": res_shapes, "pipeline": ring["shapes"],
                      "stacked": stacked_shapes, "docset": dset["shapes"],
                      "api": api["shapes"], "checkpoint": ckpt["shapes"],
                      "sync": sync["shapes"], "shard": shard_rec["shapes"],
                      "mesh": mesh_rec["shapes"],
                      "service": svc_rec["shapes"],
                      "federation": fed_rec["shapes"],
                      "adversarial": adv_rec["shapes"],
                      "soak": soak_rec["shapes"], "plan": plan_rec["shapes"]}
    log(f"launches by shape on the driven paths: {shapes_by_path}")
    shapes = {k: set().union(*(p[k] for p in shapes_by_path.values()))
              for k in S.launches}
    n_elems_of = {1_048_576: BASE_LEN, N_MERGE: n_expect}
    times = time_kernels(
        torch, S, shapes["multi_scan"], shapes["fused_segment_scans"],
        lambda sh: (n_elems_of.get(sh[0], sh[0] - sh[0] // 16)
                    if len(sh) == 1 else
                    [min(sh[1] - 1, DOCSET_ACTORS * DOCSET_CHARS)] * sh[0]))
    merge_cap = mesh_rec["materialize"]["capacity"]
    sharded_times = time_sharded(torch, M, [
        ((merge_cap,), (1, 8)), ((merge_cap,), (1, 4)),
        ((merge_cap,), (1, 2)), ((N_MERGE,), (1, 8)), ((1_048_576,), (1, 8)),
        ((DOCSET_DOCS, M.bucket(DOCSET_ACTORS * DOCSET_CHARS + 64)),
         MESH_DOCSET), ((4, 384), (2, 4))])        # the last: the dry run
    host = wrapper_host_us(torch, S)

    phase_done("7")

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
               "api": api["launches"], "checkpoint": ckpt["launches"],
               "sync": sync["launches"], "shard": shard_rec["launches"],
               "mesh": mesh_rec["launches"],
               "service": svc_rec["launches"],
               "federation": fed_rec["launches"],
               "adversarial": adv_rec["launches"],
               "soak": soak_rec["launches"], "plan": plan_rec["launches"]}
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
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in by_path.items()},
            "shape": rec["shape"], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "bound_frac": rec["bound_frac"],
            "eager_ms": eager[name],
            "eager_bound_frac": rec["bound_ms"] / eager[name],
            "kernels_per_call": per_call[name],
            "shapes": times[name],
            "host_us_per_call": {k: v[name] for k, v in host.items()
                                 if name in v},
            "launches_by_shape": {
                p: {"x".join(map(str, sh)): n for sh, n in d[name].items()}
                for p, d in shapes_by_path.items()}})
    for name in ("sharded_fused_scans", "fs_totals"):
        rec = sharded_times[name][0]           # the merge shape, 8 shards
        kernels.append({
            "name": name, "route": "cuda",
            "source": "automerge_tpu_torch/csrc/scan.cu",
            "replaces": "automerge_tpu/ops/scan_pallas.py:218",
            "launches": by_path["mesh"][name], "path": "mesh",
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in by_path.items()},
            "shape": rec["shape"], "mesh": rec["mesh"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "bound_frac": rec["bound_frac"],
            "kernels_per_call": per_call[name],
            "shapes": sharded_times[name],
            "host_us_per_call": {
                k: v["fs_totals" if name == "fs_totals"
                     else "carry-in fs_scan"] for k, v in host.items()
                if "fs_totals" in v},
            "launches_by_shape": {
                p: {"x".join(map(str, sh)): n
                    for sh, n in d.get(name, {}).items()}
                for p, d in shapes_by_path.items()}})
    log(f"phase end times (s into the run): {ends}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
