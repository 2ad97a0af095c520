#!/usr/bin/env python3
"""Tile-size sweep of the port's scan kernels at the merge shapes.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/sweep_scan_tiles.py

It writes variants of automerge_tpu_torch/csrc/scan.cu that differ from
the shipped source only in their tile constants, or in plain stores where
the source has evict-first ones, builds them all at once (one nvcc each),
holds each bit-exact against the plain PyTorch version, and times it as
chip_smoke.py times the kernels: device time over CUDA-graph replays, with
inputs rotated through copies so each call reads them from HBM. It prints
one line per variant with ptxas's register count, then one JSON list. The
shipped source keeps the constants that won; its head note says why.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

PLAIN_STORES = ("__stcs(reinterpret_cast<int4*>(p), v);",
                "*reinterpret_cast<int4*>(p) = v;")

# (kernel, label, {constant: value}, store edit or None)
VARIANTS = [
    ("multi_scan", "256 threads x 32 int32 (shipped)", {}, None),
    ("multi_scan", "128 x 32", {"kMsThreads": 128}, None),
    ("multi_scan", "512 x 16", {"kMsThreads": 512, "kMsItems": 16}, None),
    ("multi_scan", "256 x 16", {"kMsItems": 16}, None),
    ("multi_scan", "256 x 8", {"kMsItems": 8}, None),
    ("multi_scan", "256 x 32, plain stores", {}, PLAIN_STORES),
    ("fused_segment_scans", "256 threads x 32 slots (shipped)", {}, None),
    ("fused_segment_scans", "128 threads", {"kFsThreads": 128}, None),
    ("fused_segment_scans", "64 threads", {"kFsThreads": 64}, None),
    ("fused_segment_scans", "256 threads, plain stores", {}, PLAIN_STORES),
]


def variant_source(text: str, consts: dict, store) -> str:
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise AssertionError(f"{name} is not one constant of scan.cu")
    if store is not None:
        if text.count(store[0]) != 1:
            raise AssertionError("scan.cu's evict-first store moved")
        text = text.replace(store[0], store[1])
    return text


def build_all(S, keys):
    """Builds every distinct variant at once; returns {key: (lib, usage)}."""
    out_dir = S.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = S.SOURCE.read_text()
    procs = {}
    for i, (consts, store) in enumerate(keys):
        src = out_dir / f"scan_v{i}.cu"
        src.write_text(variant_source(text, dict(consts), store))
        so = src.with_suffix(".so")
        procs[(consts, store)] = (so, subprocess.Popen(
            [S._nvcc(), *S.NVCC_FLAGS, "-o", str(so), str(src)],
            stderr=subprocess.PIPE, text=True))
    built = {}
    for key, (so, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {key}:\n{err}")
        usage, fn = {}, None
        for ln in err.splitlines():
            m = re.search(r"entry function '[^']*(ms_scan|fs_scan)", ln)
            if m:
                fn = m.group(1)
            elif fn and "registers" in ln:
                usage[fn] = ln.split(": ", 1)[-1].strip()
        built[key] = (S.bind(so), usage)
    return built


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_scan_tiles: no CUDA device is available",
              file=sys.stderr)
        return 2
    from automerge_tpu_torch.ops import scan_kernels as S
    card = CS.nvidia_smi_line()
    CS.log(f"card: {card}")
    keys = sorted({(tuple(sorted(c.items())), st)
                   for _, _, c, st in VARIANTS}, key=repr)
    built = build_all(S, keys)

    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    xs = CS.ms_copies(torch, rng, 6, CS.N_MERGE, dev)
    want = S.multi_scan_plain(xs[0])
    pairs = CS.fs_copies(torch, rng, CS.N_MERGE, dev)
    ne = torch.tensor(6_000_000, dtype=torch.int32, device=dev)
    want_fs = S.fused_segment_scans_plain(*pairs[0], ne)
    rows = []
    for kernel, label, consts, store in VARIANTS:
        lib, usage = built[(tuple(sorted(consts.items())), store)]
        usage = usage.get("ms_scan" if kernel == "multi_scan" else "fs_scan")
        S._LIB = lib              # the wrappers launch this variant
        if kernel == "multi_scan":
            ok = torch.equal(S.multi_scan(xs[0]), want)
            fns = [lambda x=x: S.multi_scan(x) for x in xs]
            b_ms = CS._ms_bound(6, CS.N_MERGE)[0]
        else:
            ok = CS._fs_equal(torch, S.fused_segment_scans(*pairs[0], ne),
                              want_fs)
            fns = [lambda p=p: S.fused_segment_scans(*p, ne) for p in pairs]
            b_ms = CS._fs_bound(CS.N_MERGE)[0]
        if not ok:
            raise AssertionError(f"{kernel} variant {label} differs")
        ms = CS.time_ms(torch, fns)
        rows.append({"kernel": kernel, "variant": label, "ms": ms,
                     "bound_frac": b_ms / ms, "ptxas": usage})
        CS.log(f"{kernel} {label}: {ms:.4f} ms ({100 * b_ms / ms:.1f}% of "
               f"bound, {len(fns)} input copies); ptxas {usage}")
    S._LIB = None
    print(json.dumps(rows), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
