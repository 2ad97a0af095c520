#!/usr/bin/env python3
"""The benchmark of automerge_tpu_torch on NVIDIA H100 cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. It sets up the cell named in
BENCHMARK.json (inputs from the seed), measures for --seconds, compares
what the window produced with the plain reference, and prints one JSON
line last: with --trace 0 the cell's end-to-end metrics, with --trace 1
its per-layer metrics, the device trace's busy and window seconds and
the breakdown. The compared numbers, each with its limit, come last on
standard error and under "checks" in that line.

It exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), without the program beside it, or when a
module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time

T_START_NS = int(os.environ.get("PORTBENCH_T0_NS") or time.time_ns())


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if os.environ.get("PYTHONHASHSEED") != "0":
        # one string-hash order in every run: the host planner's set and
        # dict walks, and so its time, do not move between processes
        env = dict(os.environ, PYTHONHASHSEED="0",
                   PORTBENCH_T0_NS=str(T_START_NS))
        os.execve(sys.executable, [sys.executable, os.path.abspath(__file__)]
                  + sys.argv[1:], env)
    sys.path.insert(0, root)
    from portbench import guard, harness, spec
    harness.set_cache_dirs(root)
    cell = spec.cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench import drive
    M = drive.program()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(M, torch, cell, args.seed, args.seconds,
                              bool(args.trace), device, T_START_NS)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    import json
    print(json.dumps(result), flush=True)
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
