"""Checkpoint bundle container: versioned manifest + hashed array blobs.

A copy of the JAX package's ``checkpoint/bundle.py`` (numpy only): both
packages write and read the same bytes, so a bundle made by either
restores in the other.

An npz-style single-blob format, hand-rolled so corruption handling is
exact and deterministic:

    AMTPUCKPT1\\n | <u64 manifest length> | <sha256 of manifest bytes>
                 | <manifest JSON> | <array bytes>

The manifest is canonical JSON (sorted keys, no whitespace) carrying a
``format``/``version`` pair plus an ``arrays`` table — one entry per array
with name, dtype, shape, byte offset/length into the blob region, and a
SHA-256 content hash over ``dtype || shape || raw bytes``. The manifest
itself is covered by the header hash (clock, conflicts, value pools and
object metadata live there — a bit flip in those must fail like one in an
array). Large JSON payloads (the change history) ride as uint8 arrays so
they are hash-covered like everything else. Encoding is byte-deterministic
for a given (manifest, arrays) input — the async-capture identity tests
depend on that — so nothing time- or environment-dependent may enter here.

``decode()`` verifies structure, the manifest hash, and every array
content hash and raises the typed
:class:`~..resilience.errors.CheckpointError` on any truncation, bit
flip, or version mismatch, BEFORE any state is handed out.
"""

from __future__ import annotations

import hashlib
import json
import struct

import numpy as np

from ..resilience.errors import CheckpointError

MAGIC = b"AMTPUCKPT1\n"
FORMAT = "automerge-tpu-checkpoint"
VERSION = 1


def _array_hash(arr: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(arr.dtype.str.encode("ascii"))
    h.update(repr(tuple(arr.shape)).encode("ascii"))
    h.update(arr.tobytes())
    return h.hexdigest()


def bundle_id(data: bytes) -> str:
    """Stable identity of a bundle: SHA-256 over the full encoded bytes."""
    return hashlib.sha256(data).hexdigest()


def json_array(obj) -> np.ndarray:
    """A JSON-serializable object as a hash-coverable uint8 array.

    Keys keep their insertion order (NOT sorted): change dicts must
    round-trip byte-identically through ``api.save`` after a restore, and
    encoding stays deterministic for a given in-memory object either way."""
    raw = json.dumps(obj, separators=(",", ":"))
    return np.frombuffer(raw.encode("utf-8"), np.uint8)


def json_unarray(arr: np.ndarray):
    return json.loads(arr.tobytes().decode("utf-8"))


def encode(manifest: dict, arrays: dict) -> bytes:
    """Serialize (manifest, {name: np.ndarray}) to one bundle blob."""
    table = []
    blobs = []
    offset = 0
    for name in sorted(arrays):
        arr = np.ascontiguousarray(arrays[name])
        raw = arr.tobytes()
        table.append({"name": name, "dtype": arr.dtype.str,
                      "shape": list(arr.shape), "offset": offset,
                      "nbytes": len(raw), "sha256": _array_hash(arr)})
        blobs.append(raw)
        offset += len(raw)
    man = dict(manifest)
    man["format"] = FORMAT
    man["version"] = VERSION
    man["arrays"] = table
    mj = json.dumps(man, sort_keys=True, separators=(",", ":")).encode("utf-8")
    return (MAGIC + struct.pack("<Q", len(mj))
            + hashlib.sha256(mj).digest() + mj + b"".join(blobs))


def _parse_header(data):
    """Shared header parse + manifest integrity check for peek()/decode():
    -> (manifest dict, offset of the array-blob region)."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise CheckpointError(
            f"checkpoint bundle must be bytes, got {type(data).__name__}")
    data = bytes(data)
    hdr = len(MAGIC) + 8 + 32   # magic | u64 manifest len | manifest sha256
    if len(data) < hdr or not data.startswith(MAGIC):
        raise CheckpointError("checkpoint bundle has a bad or truncated "
                              "header (not an automerge-tpu checkpoint)")
    (mlen,) = struct.unpack_from("<Q", data, len(MAGIC))
    digest = data[len(MAGIC) + 8: hdr]
    if hdr + mlen > len(data):
        raise CheckpointError("checkpoint bundle truncated inside manifest")
    mj = data[hdr: hdr + mlen]
    if hashlib.sha256(mj).digest() != digest:
        raise CheckpointError(
            "checkpoint manifest failed its content hash (corrupt or "
            "tampered bundle)")
    try:
        manifest = json.loads(mj.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as exc:
        raise CheckpointError(
            f"checkpoint manifest is not valid JSON: {exc}") from None
    if not isinstance(manifest, dict) or manifest.get("format") != FORMAT:
        raise CheckpointError(
            f"unsupported checkpoint format: "
            f"{manifest.get('format') if isinstance(manifest, dict) else manifest!r}")
    if manifest.get("version") != VERSION:
        raise CheckpointError(
            f"unsupported checkpoint version: {manifest.get('version')!r} "
            f"(this build reads version {VERSION})")
    return manifest, hdr + mlen


def peek(data: bytes) -> dict:
    """Parse a bundle's manifest (hash-verified) WITHOUT verifying array
    hashes — for cheap metadata reads (frontier clock, engine kind).
    Restore paths must go through :func:`decode`, which verifies the
    arrays too."""
    return _parse_header(data)[0]


def decode(data: bytes):
    """Parse + integrity-check a bundle -> (manifest, {name: np.ndarray}).

    Raises :class:`CheckpointError` on any structural or hash failure."""
    manifest, base = _parse_header(data)
    data = bytes(data)
    table = manifest.get("arrays")
    if not isinstance(table, list):
        raise CheckpointError("checkpoint manifest is missing its arrays "
                              "table")
    arrays = {}
    for ent in table:
        try:
            name = ent["name"]
            dtype = np.dtype(ent["dtype"])
            shape = tuple(ent["shape"])
            off, nbytes, digest = ent["offset"], ent["nbytes"], ent["sha256"]
        except (KeyError, TypeError, ValueError) as exc:
            raise CheckpointError(
                f"malformed checkpoint array entry: {exc}") from None
        lo = base + off
        if lo < base or lo + nbytes > len(data):
            raise CheckpointError(
                f"checkpoint bundle truncated inside array {name!r}")
        arr = np.frombuffer(data[lo: lo + nbytes], dtype)
        try:
            arr = arr.reshape(shape)
        except ValueError:
            raise CheckpointError(
                f"checkpoint array {name!r} shape/byte-length mismatch"
            ) from None
        if _array_hash(arr) != digest:
            raise CheckpointError(
                f"checkpoint array {name!r} failed its content hash "
                "(corrupt or tampered bundle)")
        arrays[name] = arr
    return manifest, arrays
