#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (automerge_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--profile DIR]

It builds the CUDA kernels from csrc/, holds each kernel bit-exact against
its plain PyTorch version at the main path's shapes (and ragged ones),
times them, then drives the port's DeviceTextDoc through the headline text
merge at full width (a 1,000,000-char document taking a 10,000-actor x
1,000-op concurrent batch), the self-contained materialization, and a
residual round with the incremental pull. Every phase raises on failure.
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

def time_ms(torch, fn, reps: int = REPS) -> float:
    """Median of `reps` CUDA-event timings of fn() after two warm-ups."""
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

def check_kernels(torch, S):
    """Kernels vs plain versions on the card, bit-exact; returns the
    timing records of the main path's largest shapes."""
    rng = np.random.default_rng(1234)
    dev = torch.device("cuda")
    n_merge = 6_291_456          # bucket(5,000,000 run elements, 256)
    for K, N in [(6, 1), (6, 1000), (6, 1025), (6, 1_048_576),
                 (6, n_merge)]:
        x = torch.from_numpy(
            rng.integers(-50, 50, (K, N), dtype=np.int32)).to(dev)
        got = S.multi_scan(x)
        want = S.multi_scan_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"multi_scan differs at ({K}, {N})")
        log(f"multi_scan ({K}, {N}) bit-exact vs plain")
    for C, n_elems, base in [(1, 1, 0), (1025, 900, 0), (1025, 2000, 7),
                             (n_merge, 6_000_000, 0),
                             (n_merge, 5_999_000, 4096)]:
        chain = torch.from_numpy(rng.random(C) < 0.9).to(dev)
        has = torch.from_numpy(rng.random(C) < 0.95).to(dev)
        got = S.fused_segment_scans(chain, has, n_elems, base)
        want = S.fused_segment_scans_plain(chain, has, n_elems, base)
        torch.cuda.synchronize()
        for name, g, w in zip(("rank_incl", "seg_head", "cumvis"), got,
                              want):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"fused_segment_scans {name} differs at C={C} "
                    f"n_elems={n_elems} base={base}")
        log(f"fused_segment_scans C={C} n_elems={n_elems} base={base} "
            "bit-exact vs plain")

    recs = {}
    x = torch.from_numpy(
        rng.integers(-50, 50, (6, n_merge), dtype=np.int32)).to(dev)
    b_ms, b_by = bound(2 * x.numel() * 4, x.numel())
    recs["multi_scan"] = {
        "shape": [6, n_merge],
        "max_abs_err": int((S.multi_scan(x) - S.multi_scan_plain(x))
                           .abs().max()),
        "ms": time_ms(torch, lambda: S.multi_scan(x)),
        "plain_ms": time_ms(torch, lambda: S.multi_scan_plain(x)),
        "library_ms": time_ms(
            torch, lambda: torch.cumsum(x, 1, dtype=torch.int32)),
        "bound_ms": b_ms, "bound_by": b_by}
    C = n_merge
    chain = torch.from_numpy(rng.random(C) < 0.9).to(dev)
    has = torch.from_numpy(rng.random(C) < 0.95).to(dev)
    ne = torch.tensor(6_000_000, dtype=torch.int32, device=dev)
    got = S.fused_segment_scans(chain, has, ne)
    want = S.fused_segment_scans_plain(chain, has, ne)
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    # yardstick: the three library scans alone on precomputed inputs
    flat = torch.arange(C, dtype=torch.int32, device=dev)
    is_elem = (flat >= 1) & (flat <= ne)
    ss = (is_elem & ~chain).to(torch.int32)
    cand = torch.where(ss > 0, flat, 0)
    vis = (is_elem & has).to(torch.int32)

    def library():
        torch.cumsum(ss, 0, dtype=torch.int32)
        torch.cummax(cand, 0)
        torch.cumsum(vis, 0, dtype=torch.int32)
    # reads chain + has (1 B each) and n_elems, writes three int32 columns
    b_ms, b_by = bound(2 * C + 4 + 3 * 4 * C, 3 * C)
    recs["fused_segment_scans"] = {
        "shape": [C], "max_abs_err": err,
        "ms": time_ms(torch, lambda: S.fused_segment_scans(chain, has, ne)),
        "plain_ms": time_ms(
            torch, lambda: S.fused_segment_scans_plain(chain, has, ne)),
        "library_ms": time_ms(torch, library),
        "bound_ms": b_ms, "bound_by": b_by}
    for k, r in recs.items():
        log(f"{k} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return recs


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

    # 3. kernels vs plain
    recs = check_kernels(torch, S)

    # 4. main path at full width
    heals = heal_watch(logging)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    S.reset_launches()
    t_main = time.perf_counter()
    doc, r = drive_stream(DeviceTextDoc, TB, C, None, planned=True)
    main_launches = dict(S.launches)
    t_main = time.perf_counter() - t_main
    peak = torch.cuda.max_memory_allocated()
    log(f"main path launches: {main_launches}")
    if main_launches["multi_scan"] < 1:
        raise AssertionError("multi_scan did not launch on the main path")
    n_expect = BASE_LEN + N_ACTORS * (OPS_PER_CHANGE // 2)
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

    # 7. optional profile of the headline commit
    if args.profile:
        for planned in (True, False):
            profile_commit(torch, DeviceTextDoc, TB, C, planned,
                           args.profile)

    # 8. kernel records: `launches` is the count on the path the kernel
    # serves (multi_scan: the planned main path; fused_segment_scans: the
    # self-contained one); `launches_by_path` has each driven path's count
    by_path = {"main": main_launches, "self_contained": sc_launches,
               "residual": res_launches}
    kernels = []
    for name, replaces, path in (
            ("multi_scan", "automerge_tpu/ops/scan_pallas.py:204", "main"),
            ("fused_segment_scans", "automerge_tpu/ops/scan_pallas.py:142",
             "self_contained")):
        rec = recs[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "automerge_tpu_torch/csrc/scan.cu",
            "replaces": replaces, "launches": by_path[path][name],
            "path": path,
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "shape": rec["shape"], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
