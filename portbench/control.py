#!/usr/bin/env python3
"""The control of each cell's comparison: the plain reference put in the
program's place with one guarantee of the configuration broken, so that
the comparison can be seen to fail. The guarantee is that every
acknowledged change is in the text read back; each family's `CONTROL`
(`families/<family>.py`) leaves one acknowledged change out of each
unit: the last change of a session's backlog, the last actor's run of
one document of a build, or one document's read after a round (it shows
the document as it was before the round; the later rounds build on the
change, as they would on a server that lost only the read).

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--units N]

Run from the root of a checkout. It makes the cell's traffic at the
cell's own size from each seed, runs N sessions or rounds of the control
(20 by default), and prints each compared number beside its limit, one
JSON line a seed. The benchmark's runs never run it.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import spec  # noqa: E402


def run_control(cell, seed: int, units: int) -> dict:
    runner = spec.family(cell.traffic["family"]).CONTROL(
        None, None, cell.config, cell.traffic, seed)
    runner.setup(0.0)
    for _ in range(units):
        runner.unit()
        runner.attempted += 1
    runner.release()
    checks, failed = runner.check()
    return {"workload": cell.name, "seed": seed, "units": units,
            "correct": all(v <= lim for v, lim in checks.values()),
            "failed": failed,
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=20)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(run_control(cell, seed, args.units)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
