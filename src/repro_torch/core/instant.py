"""Instant checkpointing: neighboring redundancy (paper §4.2, Fig. 3 (B)),
port of ``repro.core.instant``.

Each iteration, every rank sends its *unique* state shard to the next rank
of the DP ring: one ``torch.distributed.batch_isend_irecv`` over all the
leaves (``Mesh.ring_exchange``), the counterpart of the reference's
``lax.ppermute`` inside the compiled step. The received shards come back as
a step *output*; the caller keeps them as the neighbor's live checkpoint.
"""
from __future__ import annotations

from typing import Any

from repro_torch.parallel.sharding import is_spec
from repro_torch.tree import tree_flatten, tree_unflatten

PyTree = Any


def ring_perm(n: int, shift: int = 1):
    return [(i, (i + shift) % n) for i in range(n)]


def neighbor_backup(tree: PyTree, pspecs: PyTree, mesh, *, axis: str = "data",
                    shift: int = 1) -> PyTree:
    """Every present leaf of this rank goes to rank ``(r + shift) % n`` of
    ``axis``, and this rank receives the same leaves of rank
    ``(r - shift) % n``; returns the received tree.

    tree/pspecs may contain None leaves (razor-redundant): they pass through
    untouched and cost no traffic. At ``n <= 1`` the tree is returned as it
    is, as the reference does.
    """
    n = mesh.shape[axis]
    if n <= 1:
        return tree
    flat_specs, treedef = tree_flatten(pspecs, is_spec)
    flat_vals, vals_def = tree_flatten(tree, lambda x: x is None)
    if vals_def != treedef:
        raise ValueError("the tree and its specs differ in structure")
    present = [i for i, (v, s) in enumerate(zip(flat_vals, flat_specs)) if v is not None]
    if not present:
        return tree
    received = mesh.ring_exchange([flat_vals[i] for i in present], axis, shift)
    new_flat = list(flat_vals)
    for i, r in zip(present, received):
        new_flat[i] = r
    return tree_unflatten(treedef, new_flat)
