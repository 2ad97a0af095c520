"""The host codec of the PyTorch engine: plain C++ over ctypes.

`codec.cpp` (a copy of the JAX package's `automerge_tpu/native/codec.cpp`)
holds two host passes of the ingest path:

- `decode_text_changes(data, obj_id)` — a JSON change list straight into
  a columnar `TextChangeBatch`. A payload outside the codec's scope (rich
  values, non-list objects, malformed changes, out-of-int32 numbers) is
  declined: it returns None and the caller decodes it with the Python
  decoder, which is the documented semantics and not a failure.
  `routes["native"]` / `routes["python"]` count the batches each decoder
  produced (engine/columnar.py).
- `detect_runs_native(...)` — the single-pass typing-run walker,
  bit-identical to the numpy form (engine/runs.py `_detect_runs_numpy`).

The library is built with `g++` at first use into `native/build/`; its
file name carries a digest of the source and the flags, and it is written
under a temporary name and renamed into place, so concurrent processes do
not race. A failed build raises with the compiler's output: nothing falls
back to the Python paths because the library is missing. ctypes releases
the GIL for the duration of each call, so the planner pool's threads walk
their shards in parallel. Each compile and each load of the library is a
build/load event of the device-truth registry (obs/device_truth.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..obs import device_truth as _dt

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "codec.cpp"
BUILD_DIR = _HERE / "build"

#: batches decoded by each route since the last `reset_counts()`
routes = {"native": 0, "python": 0}
#: single-pass walks of the native run detector since `reset_counts()`
walks = {"native": 0}

_LIB = None
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()    # the planner pool's threads count too


def reset_counts():
    with _COUNT_LOCK:
        for d in (routes, walks):
            for k in d:
                d[k] = 0


def count(counter: dict, key: str):
    with _COUNT_LOCK:
        counter[key] += 1


def _host_supports_avx2() -> bool:
    """True iff this machine's CPU runs AVX2: g++ compiles -march=x86-64-v3
    on any x86 host, and the library would die with SIGILL at the first
    vectorized call where the CPU lacks it."""
    try:
        with open("/proc/cpuinfo") as fh:
            return "avx2" in fh.read()
    except OSError:
        return False


def build_flags() -> list:
    # x86-64-v3 (AVX2/FMA) lets gcc vectorize the walker's predicate
    # loops; not -march=native, so the library runs on any AVX2 host
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
    if _host_supports_avx2():
        flags.insert(0, "-march=x86-64-v3")
    return flags


def library_path(flags=None) -> Path:
    """Where the library of the current source and flags is or will be
    built."""
    flags = build_flags() if flags is None else flags
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"libamt_codec_{h.hexdigest()[:16]}.so"


def build(compiler: str = "g++") -> Path:
    """Compile `codec.cpp` if its library is missing; returns its path.
    Raises RuntimeError with the compiler's output on failure."""
    flags = build_flags()
    so = library_path(flags)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter_ns()
    try:
        proc = subprocess.run([compiler, *flags, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"building {SOURCE} with {compiler} failed: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed ({proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stderr}")
    os.replace(tmp, so)
    _dt.record_build("native_codec", "build", time.perf_counter_ns() - t0,
                     so.name)
    return so


def bind(path) -> ctypes.CDLL:
    """The library at `path`, with the argument types of its entry points."""
    lib = ctypes.CDLL(str(path))
    vp = ctypes.c_void_p

    def arr(dtype):
        return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")
    lib.amtpu_parse.restype = vp
    lib.amtpu_parse.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                ctypes.c_char_p]
    lib.amtpu_error.restype = ctypes.c_char_p
    lib.amtpu_error.argtypes = [vp]
    for name in ("amtpu_unsupported", "amtpu_n_changes", "amtpu_n_ops",
                 "amtpu_n_actors"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [vp]
    lib.amtpu_fill_ops.restype = None
    lib.amtpu_fill_ops.argtypes = [vp] + [
        arr(dt) for dt in (np.int32, np.int8, np.int32, np.int32, np.int32,
                           np.int32, np.int64)]
    lib.amtpu_fill_seqs.restype = None
    lib.amtpu_fill_seqs.argtypes = [vp, arr(np.int32)]
    for name in ("amtpu_actors", "amtpu_actor_table", "amtpu_deps",
                 "amtpu_messages"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [vp]
    lib.amtpu_free.restype = None
    lib.amtpu_free.argtypes = [vp]
    lib.amtpu_detect_runs.restype = vp
    lib.amtpu_detect_runs.argtypes = [
        ctypes.c_int64, arr(np.int8), arr(np.int32), arr(np.int32),
        arr(np.int32), arr(np.int32), arr(np.int64), arr(np.int32),
        ctypes.c_int64]
    for name in ("amtpu_plan_n_runs", "amtpu_plan_n_pairs",
                 "amtpu_plan_n_res", "amtpu_plan_n_ins"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [vp]
    lib.amtpu_plan_blob_lt.restype = ctypes.c_int
    lib.amtpu_plan_blob_lt.argtypes = [vp, ctypes.c_int]
    lib.amtpu_plan_fill.restype = None
    lib.amtpu_plan_fill.argtypes = [vp] + [arr(np.int64)] * 5 + [
        arr(np.int32)]
    lib.amtpu_plan_free.restype = None
    lib.amtpu_plan_free.argtypes = [vp]
    return lib


def load() -> ctypes.CDLL:
    """The bound codec library (built first if needed); raises if the
    build fails."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = build()
            t0 = time.perf_counter_ns()
            _LIB = bind(so)
            _dt.record_build("native_codec", "load",
                             time.perf_counter_ns() - t0, so.name)
    return _LIB


def detect_runs_native(kind, ta, tc, pa, pc, val64, op_row,
                       base_elems: int):
    """Single-pass C++ typing-run detection over one round's op columns.

    Returns (hpos, run_len, head_slot, rpos, res_new_slot, blob, n_ins,
    blob_lt_128, blob_lt_256), bit-identical to `_detect_runs_numpy`."""
    lib = load()
    n = len(kind)
    cols = (np.ascontiguousarray(kind, np.int8),
            np.ascontiguousarray(ta, np.int32),
            np.ascontiguousarray(tc, np.int32),
            np.ascontiguousarray(pa, np.int32),
            np.ascontiguousarray(pc, np.int32),
            np.ascontiguousarray(val64, np.int64),
            np.ascontiguousarray(op_row, np.int32))
    h = lib.amtpu_detect_runs(n, *cols, base_elems)
    try:
        n_runs = lib.amtpu_plan_n_runs(h)
        n_pairs = lib.amtpu_plan_n_pairs(h)
        n_res = lib.amtpu_plan_n_res(h)
        hpos = np.empty(n_runs, np.int64)
        run_len = np.empty(n_runs, np.int64)
        head_slot = np.empty(n_runs, np.int64)
        rpos = np.empty(n_res, np.int64)
        res_new_slot = np.empty(n_res, np.int64)
        blob = np.empty(n_pairs, np.int32)
        lib.amtpu_plan_fill(h, hpos, run_len, head_slot, rpos,
                            res_new_slot, blob)
        out = (hpos, run_len, head_slot, rpos, res_new_slot, blob,
               int(lib.amtpu_plan_n_ins(h)),
               bool(lib.amtpu_plan_blob_lt(h, 128)),
               bool(lib.amtpu_plan_blob_lt(h, 256)))
    finally:
        lib.amtpu_plan_free(h)
    count(walks, "native")
    return out


def decode_text_changes(data, obj_id: str):
    """JSON change list (str/bytes) -> TextChangeBatch, or None when the
    payload is outside the codec's scope (the caller then decodes it with
    the Python decoder)."""
    lib = load()
    if isinstance(data, str):
        data = data.encode("utf-8")
    h = lib.amtpu_parse(data, len(data), obj_id.encode("utf-8"))
    try:
        if lib.amtpu_unsupported(h):
            return None
        n_changes = lib.amtpu_n_changes(h)
        n_ops = lib.amtpu_n_ops(h)
        op_change = np.empty(n_ops, np.int32)
        op_kind = np.empty(n_ops, np.int8)
        ta = np.empty(n_ops, np.int32)
        tc = np.empty(n_ops, np.int32)
        pa = np.empty(n_ops, np.int32)
        pc = np.empty(n_ops, np.int32)
        val = np.empty(n_ops, np.int64)
        if n_ops:
            lib.amtpu_fill_ops(h, op_change, op_kind, ta, tc, pa, pc, val)
        seqs = np.empty(n_changes, np.int32)
        if n_changes:
            lib.amtpu_fill_seqs(h, seqs)

        def split(raw):
            s = raw.decode("utf-8")
            return s.split("\n") if s else []

        from ..engine.columnar import TextChangeBatch, intern_deps
        actors = split(lib.amtpu_actors(h))
        actor_table = split(lib.amtpu_actor_table(h))
        deps = intern_deps([json.loads(d) for d in split(lib.amtpu_deps(h))])
        raw_msgs = lib.amtpu_messages(h).decode("utf-8")
        messages = []
        if n_changes:
            for part in raw_msgs.split("\x1f"):
                messages.append(part[1:] if part[:1] == "1" else None)
        if not (len(actors) == len(deps) == len(messages) == n_changes):
            return None          # malformed joins: the Python decoder
        return TextChangeBatch(
            obj_id=obj_id, actors=actors, seqs=seqs, deps=deps,
            messages=messages, op_change=op_change, op_kind=op_kind,
            op_target_actor=ta, op_target_ctr=tc, op_parent_actor=pa,
            op_parent_ctr=pc, op_value=val, actor_table=actor_table,
            value_pool=[])
    finally:
        lib.amtpu_free(h)
