#!/usr/bin/env python3
"""chip_smoke.py's phases 4 and 5 — the headline merge's commit+sync on
the planned and the self-contained path — in fresh processes,
alternating two checkouts.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/paired_commit.py --parent ROOT [--pairs 5]

ROOT is another checkout, such as the parent commit unpacked with `git
archive`. Each process imports its checkout's chip_smoke.py and runs, as
that script does, the kernel and host-codec builds, phase 3 (bit-exact
kernel checks, one eager call of each kernel at the merge shapes: the
first timed commit moves with what ran before it), phase 4 (the planned
stream, text checked against the reference) and phase 5 (the
self-contained stream). The order is P C C P per pair, after one
untimed warm-up process. Each process prints one JSON line; the last
line is a JSON summary: each variant's readings and medians, and the
change/parent ratio of the medians.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str) -> dict:
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    M = cs.port_modules()
    with ThreadPoolExecutor(2) as ex:
        native = ex.submit(M.native.load)
        M.S.build()
        native.result()
    cs.check_kernels(torch, M.S)
    cs.time_eager_merge(torch, M.S)
    out = {"root": root}
    for planned in (True, False):
        doc, r = cs.drive_stream(M.DeviceTextDoc, M.TB, M.C, None,
                                 planned=planned)
        want = cs.expected_merge_text(cs.BASE_LEN, cs.N_ACTORS,
                                      cs.OPS_PER_CHANGE // 2)
        if r["text"] != want:
            raise AssertionError(f"{root}: merged text differs")
        key = "planned" if planned else "self_contained"
        out[key] = {"prepare_s": r["prepare_s"], "commit_s": r["commit_s"]}
        del doc
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", metavar="ROOT", required=True)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    roots = {"parent": os.path.abspath(args.parent), "change": ROOT}
    order = ["change"] + ["parent", "change", "change", "parent"] * args.pairs
    runs = {"parent": [], "change": []}
    for i, variant in enumerate(order):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent",
             args.parent, "--child", roots[variant]],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{variant} process failed")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec.update(variant=variant, warmup=i == 0,
                   wall_s=time.perf_counter() - t)
        print(json.dumps(rec), flush=True)
        if i:
            runs[variant].append(rec)
    summary = {}
    for variant, recs in runs.items():
        summary[variant] = {
            f"{path}_{k}": {
                "runs": [r[path][k] for r in recs],
                "median": float(np.median([r[path][k] for r in recs]))}
            for path in ("planned", "self_contained")
            for k in ("prepare_s", "commit_s")}
    summary["ratio_change_over_parent"] = {
        k: summary["change"][k]["median"] / summary["parent"][k]["median"]
        for k in summary["change"]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
