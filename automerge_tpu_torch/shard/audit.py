"""Exchange audit of the sharded commit path.

Counterpart of `automerge_tpu/shard/audit.py`. The serving tier's scaling
claim rests on one invariant: the commit path moves ZERO bytes between
devices. The JAX package proves it by lowering the round kernels with
every operand sharded over a doc-only mesh and counting collectives in
the compiled HLO. The port compiles no HLO: its programs run per shard on
a `parallel.Mesh`, and every byte that moves between shards goes through
the mesh's exchange functions, which count their calls
(`parallel.mesh.calls`). So the audit runs each commit-path program once
over a doc-only mesh (`map_shards`, one doc group a shard) and reports
the exchange calls it made; on a card it also counts, in a
`torch.profiler` trace of the run, NCCL kernels and peer-to-peer
memcpys, which a program could reach without the exchange functions.

Audited: the port's commit-path programs at the JAX audit's shapes
(audit.py:59-108 there) — `fused_stacked_round` (both lanes),
`fused_scatter_registers`, `fused_commit_round`,
`fused_commit_round_planned` and the mixed round over the doc axis
(`fused_mixed_round`). The JAX package's XLA comparators
(`stacked_map_round`, `stacked_mixed_round`, `stacked_scatter_registers`,
`merge_and_materialize_dense`, `merge_and_materialize_dense_planned`)
were left out of the port on purpose, so they have no twin here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import mesh as pm


def _trace_counts(fn, args) -> dict:
    """Run fn(*args) under torch.profiler on the card: NCCL kernels and
    peer-to-peer memcpys in its trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"nccl_kernels": sum(n.lower().startswith("nccl") for n in names),
            "peer_memcpy": sum("PtoP" in n for n in names)}


def _on_cuda(args) -> bool:
    for a in args:
        if isinstance(a, pm.ShardedArray):
            if any(b.device.type == "cuda" for b in a.blocks.values()):
                return True
        elif torch.is_tensor(a) and a.device.type == "cuda":
            return True
    return False


def count_collectives(fn, args) -> dict:
    """Run fn(*args) once and count what it moved between shards: the
    mesh's exchange calls by function, and on a card the NCCL kernels and
    peer memcpys of its trace (zero-count keys dropped — an empty dict
    IS the pass)."""
    before = dict(pm.calls)
    if _on_cuda(args):
        extra = _trace_counts(fn, args)
    else:
        fn(*args)
        extra = {}
    counts = {k: pm.calls[k] - before[k] for k in pm.calls}
    counts.update(extra)
    return {k: n for k, n in counts.items() if n}


def doc_mesh(n_devices: int = None, *, devices=None) -> pm.Mesh:
    """A doc-axis-only mesh (elem axis of 1) over the process's cards, or
    over `devices` (repeats allowed: virtual shards)."""
    devices = pm.cuda_devices() if devices is None else list(devices)
    n = n_devices or len(devices)
    return pm.make_mesh(n, doc_axis=n, devices=devices)


def _per_doc(program):
    """A one-document program run over every doc of a shard's block,
    its outputs stacked over the doc axis again."""
    def run(_coord, *blocks):
        outs = [program(*(b[i] for b in blocks))
                for i in range(blocks[0].shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    return run


def commit_path_collectives(mesh=None, docs_per_device: int = 2,
                            cap: int = 256) -> dict:
    """Audit the commit-path programs over a doc-sharded mesh: {program
    name: {exchange or trace counter: count}} (empty inner dicts = the
    zero-exchange invariant holds). Shapes are small — the audit is about
    the programs' structure, not scale."""
    from ..ops import fused_round as F
    from ..ops import ingest as K

    if mesh is None:
        mesh = doc_mesh()
    if mesh.shape["elem"] != 1:
        raise ValueError("the commit-path audit runs over a doc-only mesh")
    D = mesh.shape["doc"] * docs_per_device
    M, R, N, Kc, T, S = 64, 64, 256, 64, 64, 64
    spec = ("doc",)

    def put(arr):
        return pm.shard(mesh, arr, spec)

    i32 = np.int32
    elem_tables = (put(np.zeros((D, cap), i32)),          # parent
                   put(np.zeros((D, cap), i32)),          # ctr
                   put(np.zeros((D, cap), i32)),          # actor
                   put(np.zeros((D, cap), i32)),          # value
                   put(np.zeros((D, cap), bool)),         # has_value
                   put(np.full((D, cap), -1, i32)),       # win_actor
                   put(np.zeros((D, cap), i32)),          # win_seq
                   put(np.zeros((D, cap), bool)),         # win_counter
                   put(np.zeros((D, cap), bool)))         # chain
    reg_tables = (put(np.zeros((D, cap), i32)),           # value
                  put(np.zeros((D, cap), bool)),          # has_value
                  put(np.full((D, cap), -1, i32)),        # win_actor
                  put(np.zeros((D, cap), i32)),           # win_seq
                  put(np.zeros((D, cap), bool)))          # win_counter

    ops = np.zeros((D, 5, M), i32)
    ops[:, K.MOP_KIND, :] = -1
    ops[:, K.MOP_SLOT, :] = cap
    conflict = np.full((D, Kc), cap, i32)
    desc = np.zeros((D, 9, R), i32)
    desc[:, K.DESC_ELEM_BASE, :] = N
    blob = np.zeros((D, N), i32)
    res = np.zeros((D, 8, M), i32)
    res[:, 0, :] = -1
    res[:, K.RES_SLOT, :] = cap
    res[:, K.RES_NEW_SLOT, :] = cap
    touch = np.zeros((D, 3, T), i32)
    touch[:, 1:, :] = -1
    wb = np.zeros((D, 6, S), i32)
    wb[:, 0, :] = cap
    segplan = np.zeros((D, 4, S), i32)
    ops, conflict, desc, blob, res, touch, wb, segplan = map(
        put, (ops, conflict, desc, blob, res, touch, wb, segplan))

    def program(fn):
        return lambda *a: pm.map_shards(fn, *a, out=spec)

    out = {}
    # one causal round of every stacked map and text document, both lanes
    out["fused_stacked_round"] = count_collectives(program(
        lambda _c, *a: F.fused_stacked_round(
            *a, map_cap=cap, text_cap=cap, with_map=True, with_text=True)),
        reg_tables + (ops, conflict) + elem_tables
        + (desc, blob, res, conflict, touch))
    # both lanes' host-resolved slow residue, one stacked scatter
    out["fused_scatter_registers"] = count_collectives(program(
        lambda _c, *a: F.fused_scatter_registers(
            *a, with_map=True, with_text=True)),
        reg_tables + (wb,) + elem_tables[3:8] + (wb,))
    # the mixed round of every text document over the doc axis (dense
    # expansion + residuals + touches — the worst case)
    out["fused_mixed_round"] = count_collectives(program(
        lambda _c, *a: F._fused_mixed_core_r(*a, out_cap=cap)),
        elem_tables + (desc, blob, res, conflict, touch))
    # the ring-commit programs (the whole dense merge round with its
    # materialization), one document at a time within each shard
    out["fused_commit_round"] = count_collectives(program(_per_doc(
        lambda *a: F.fused_commit_round(*a, out_cap=cap, S=S, as_u8=True,
                                        L=cap))),
        elem_tables + (desc, blob))
    out["fused_commit_round_planned"] = count_collectives(program(_per_doc(
        lambda *a: F.fused_commit_round_planned(
            *a, out_cap=cap, S=S, as_u8=True, L=cap))),
        elem_tables + (desc, blob, segplan))
    return out


def assert_zero_collectives(audit: dict):
    """The acceptance form: every audited commit-path program ran with
    zero exchanges between shards."""
    bad = {k: v for k, v in audit.items() if v}
    assert not bad, (
        f"sharded commit path moved data between shards: {bad} — the "
        "doc axis is no longer communication-free")
