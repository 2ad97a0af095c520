#!/usr/bin/env python3
"""What a process does before chip_smoke.py's phase 3, and the host time
of one scan-kernel wrapper call after it.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/eager_wrapper_host.py [--parent ROOT] [--rounds 4]

Each variant runs in a fresh process. It builds the scan kernels, runs
chip_smoke.py's phase-3 checks and its one-eager-call timing at the merge
shapes (`time_eager_merge`), then times the host side of 200 back-to-back
wrapper calls at the merge shapes, with the garbage collector on and off.
The variants differ only in what they do before phase 3:

- `parent`: ROOT's package and chip_smoke.py (another checkout, such as
  the parent commit unpacked with `git archive`), nvcc build only;
- `no_codec`: this checkout, every module chip_smoke.py imports, nvcc
  build only;
- `codec_after`: as `no_codec`, then the host codec loaded on the main
  thread;
- `codec_pool`: as chip_smoke.py does it, nvcc and the host codec built
  together in a two-thread pool.

Variants run interleaved, `--rounds` times each. Each process prints one
JSON line; the last line is a JSON summary with the median of each
reading per variant.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 200


def host_us(torch, fn, calls: int = CALLS) -> float:
    """Mean host seconds (in µs) of one fn() call over `calls` calls
    issued back to back; the card drains after the clock stops."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e6


def child(variant: str, root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as CS
    if variant == "parent":
        from automerge_tpu_torch.engine import accounting  # noqa: F401
        from automerge_tpu_torch.engine.text_doc import (  # noqa: F401
            DeviceTextDoc)
        from automerge_tpu_torch.ops import scan_kernels as S
        S.build()
    else:
        M = CS.port_modules()
        S = M.S
        if variant == "codec_pool":
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(2) as ex:
                codec = ex.submit(M.native.load)
                S.build()
                codec.result()
        else:
            S.build()
            if variant == "codec_after":
                M.native.load()
    CS.check_kernels(torch, S)
    eager = CS.time_eager_merge(torch, S)
    rng = np.random.default_rng(42)
    dev = torch.device("cuda")
    x = torch.from_numpy(
        rng.integers(-50, 50, (6, CS.N_MERGE), dtype=np.int32)).to(dev)
    chain, has = CS._fs_inputs(torch, rng, CS.N_MERGE, dev)
    ne = torch.tensor(6_000_000, dtype=torch.int32, device=dev)
    calls = {"multi_scan": lambda: S.multi_scan(x),
             "fused_segment_scans":
                 lambda: S.fused_segment_scans(chain, has, ne)}
    host = {k: host_us(torch, f) for k, f in calls.items()}
    gc.disable()
    host_nogc = {k: host_us(torch, f) for k, f in calls.items()}
    gc.enable()
    return {"variant": variant, "eager_ms": eager, "host_us": host,
            "host_us_nogc": host_nogc, "gc_objects": len(gc.get_objects()),
            "threads": threading.active_count(),
            "modules": len(sys.modules)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", metavar="ROOT", default=None,
                    help="another checkout to run as the `parent` variant")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.root)))
        return 0
    variants = [("no_codec", ROOT), ("codec_after", ROOT),
                ("codec_pool", ROOT)]
    if args.parent:
        variants.insert(0, ("parent", os.path.abspath(args.parent)))
    recs = []
    for _ in range(args.rounds):
        for variant, root in variants:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 variant, "--root", root],
                cwd=root, capture_output=True, text=True, check=True)
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    summary = {}
    for variant, _ in variants:
        rs = [r for r in recs if r["variant"] == variant]
        summary[variant] = {
            f"{field}/{k}": float(np.median([r[field][k] for r in rs]))
            for field in ("eager_ms", "host_us", "host_us_nogc")
            for k in rs[0][field]}
        summary[variant]["gc_objects"] = rs[0]["gc_objects"]
        summary[variant]["modules"] = rs[0]["modules"]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
