"""Multi-shard dry run: the full DocSet engine over a (doc, elem) mesh.

Counterpart of `automerge_tpu/parallel/_dryrun.py`. The JAX package execs
its body in a subprocess whose environment forces eight virtual CPU
devices; the port's mesh takes its devices as a list, so the same body
runs in-process on a mesh of virtual shards: `n_shards` entries of one
device (the card unless the caller names another).

    python3 -m automerge_tpu_torch.parallel._dryrun [n_shards] [device]
"""

from __future__ import annotations


def _devices(n_shards: int, devices):
    import torch
    from ..engine.base import resolve_device
    if devices is None or isinstance(devices, (str, torch.device)):
        return [resolve_device(devices)] * n_shards
    return list(devices)


def run(n_shards: int, devices=None) -> None:
    """Run the REAL multi-doc engine over an n-shard (doc, elem) mesh:
    stacked element tables sharded doc-data-parallel and elem-sequence-
    parallel, a fast-tier round per doc group, the sharded scans and
    planned materialization of `texts()`. Executes a full merge +
    materialize on tiny shapes and checks the output."""
    from ..engine import DeviceTextDocSet, TextChangeBatch
    from .mesh import make_mesh

    mesh = make_mesh(n_shards, devices=_devices(n_shards, devices))
    n_docs = mesh.shape["doc"] * 2

    def typing(actor, seq, text, obj, start=1, after="_head", deps=None):
        ops, key = [], after
        for i, c in enumerate(text):
            ops += [{"action": "ins", "obj": obj, "key": key,
                     "elem": start + i},
                    {"action": "set", "obj": obj, "key":
                     f"{actor}:{start + i}", "value": c}]
            key = f"{actor}:{start + i}"
        return {"actor": actor, "seq": seq, "deps": deps or {}, "ops": ops}

    ids = [f"doc{i}" for i in range(n_docs)]
    ds = DeviceTextDocSet(ids, capacity=mesh.shape["elem"] * 16, mesh=mesh)
    # round 1: two concurrent writers per doc from the head
    ds.apply_batches({o: TextChangeBatch.from_changes(
        [typing("alice", 1, f"hi{i % 10}xxxx!", o),
         typing("bob", 1, "concurrent", o)], o)
        for i, o in enumerate(ids)})
    # round 2: alice continues her own run (chain continuation + breaks)
    ds.apply_batches({o: TextChangeBatch.from_changes(
        [typing("alice", 2, "++", o, start=9, after="alice:8")], o)
        for o in ids})
    texts = ds.texts()
    assert len(texts) == n_docs
    assert all(len(t) == 20 for t in texts.values()), texts
    assert all("concurrent" in t and "++" in t for t in texts.values())


if __name__ == "__main__":
    import sys

    run(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
        sys.argv[2] if len(sys.argv) > 2 else None)
    print("dryrun_multichip: OK")
