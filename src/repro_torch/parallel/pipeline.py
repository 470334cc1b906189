"""GPipe pipeline parallelism over a "pipe" mesh axis (port of
``repro.parallel.pipeline``).

The layer-stacked params' leading dim is split over "pipe": each rank, one
stage, holds L/P consecutive layers. The schedule is GPipe's with M
microbatches over M + P - 1 ticks: at tick t stage 0 takes microbatch t,
every stage runs its layers on the microbatch it holds, and the
activations go one stage on (``Mesh.ring_exchange``; the last stage's go
round to stage 0, which ignores them, so the cyclic shift does what the
reference's non-cyclic ``ppermute`` does). The bubble fraction is
(P - 1) / (M + P - 1). Forward only, as the reference.

The reference's ``shard_map`` runs every stage on every tick and throws
away the bubble ticks' work (zeros in, ignored out); here a stage skips its
bubble ticks and hands on zeros, so it runs its layers M times, not
M + P - 1. The outputs are the same.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import tree_flatten, tree_unflatten

PyTree = Any


@torch.no_grad()
def pipeline_forward(
    layer_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
    stacked_params: PyTree,          # this stage's block: leaves (L/P, ...)
    x: torch.Tensor,                 # (M, mb, S, D): M microbatches, on every rank
    mesh,
    *,
    axis: str = "pipe",
) -> torch.Tensor:
    """Runs x through L layers split across the pipe axis, GPipe schedule.
    Returns (M, mb, S, D) on every rank.

    ``stacked_params`` is this rank's block of the layer stack sharded on
    its leading dim over ``axis`` (the port's form of the reference's
    ``P(axis)`` input: ``parallel.sharding.local_block(leaf, P(axis), mesh)``
    cuts it); ``layer_fn(p, h)`` runs one layer of it. ``x`` is replicated
    (only stage 0 reads it) and the last stage's outputs are broadcast to
    every rank, as the reference's masked ``psum`` replicates them. A
    collective over ``axis``: every rank of it calls it."""
    n_stages = mesh.shape[axis]
    stage = mesh.index(axis)
    m = x.shape[0]
    leaves, treedef = tree_flatten(stacked_params)
    layers = [tree_unflatten(treedef, [leaf[i] for leaf in leaves])
              for i in range(leaves[0].shape[0])]

    outputs = torch.zeros_like(x)
    inflight = idle = torch.zeros_like(x[0])
    for t in range(m + n_stages - 1):
        mb = t - stage                  # the microbatch this stage holds at tick t
        if 0 <= mb < m:
            h = x[t] if stage == 0 else inflight
            for p in layers:
                h = layer_fn(p, h)
            if stage == n_stages - 1:
                outputs[mb] = h
        else:                           # a bubble tick: nothing to run
            h = idle
        inflight, = mesh.ring_exchange([h], axis)
    return mesh.broadcast(outputs, axis, n_stages - 1)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
