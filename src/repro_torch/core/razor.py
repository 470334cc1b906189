"""Checkpoint razor (paper §4.2): classify training state into *unique* and
*redundant* leaves given the parallelism configuration (port of
``repro.core.razor``).

Rules (paper's two + the reference's EP/TP generalization):
  1. dp > 1  =>  bf16 params are redundant (re-castable from the fp32 master,
     and replicated across the DP group anyway).
  2. ZeRO-sharded optimizer leaves (spec mentions the "data" axis) are unique
     per device — they MUST be backed up (12·φ/d bytes for Adam).
  3. TP/EP-sharded-only leaves are unique *per model-parallel rank* but
     replicated across DP — one DP peer suffices, so they're redundant for
     per-iteration backup and persisted lazily at recovery (lazy backup).
  4. dp == 1  =>  everything is unique.

``razor_plan`` takes the port's specs (``repro_torch.parallel.sharding.P``)
and leaves with ``.shape`` and ``.dtype`` (the meta tensors of
``train.state.make_state_specs``). The plan's ``unique_mask`` drives the
instant (per-iteration) neighbor backup of ``train.step.build_train_step``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def _mentions(spec, axis: str) -> bool:
    for part in spec:
        if part == axis:
            return True
        if isinstance(part, (tuple, list)) and axis in part:
            return True
    return False


def _nbytes(leaf) -> int:
    return math.prod(leaf.shape) * leaf.dtype.itemsize


@dataclass
class RazorPlan:
    """Result of razor classification over the full train-state tree."""
    unique_mask: PyTree          # bool per leaf of opt state: back up per-iter
    dp: int
    unique_bytes: int            # global bytes of unique state (sum of shards)
    redundant_bytes: int         # global bytes of razor-eliminated state
    full_bytes: int              # what a traditional full CKPT would save

    @property
    def unique_bytes_per_device_ring(self) -> int:
        """Bytes each device sends to its DP neighbor per iteration."""
        return self.unique_bytes // max(self.dp, 1)

    @property
    def reduction(self) -> float:
        return 1.0 - self.unique_bytes / max(self.full_bytes, 1)


def razor_plan(opt_specs: PyTree, opt_pspecs: PyTree, param_specs: PyTree,
               mesh, *, zero_axis: str = "data") -> RazorPlan:
    dp = mesh.shape[zero_axis] if zero_axis in mesh.axis_names else 1

    def classify(spec_leaf, pspec):
        if dp <= 1:
            return True
        return _mentions(pspec, zero_axis)

    unique_mask = tree_map(classify, opt_specs, opt_pspecs)

    opt_leaves = tree_leaves(opt_specs)
    mask_leaves = tree_leaves(unique_mask)
    unique_bytes = sum(_nbytes(l) for l, m in zip(opt_leaves, mask_leaves) if m)
    redundant_opt = sum(_nbytes(l) for l, m in zip(opt_leaves, mask_leaves) if not m)
    param_bytes = sum(_nbytes(l) for l in tree_leaves(param_specs))
    # A traditional engine persists weights + full optimizer state from EVERY
    # DP replica (the paper's 16 phi per device); the razor keeps exactly one
    # ZeRO-sharded copy of the optimizer state.
    full_bytes = dp * (param_bytes + unique_bytes + redundant_opt)
    return RazorPlan(
        unique_mask=unique_mask,
        dp=dp,
        unique_bytes=unique_bytes,
        redundant_bytes=full_bytes - unique_bytes,
        full_bytes=full_bytes,
    )


def select_unique(tree: PyTree, mask: PyTree) -> PyTree:
    """Subtree of leaves marked unique (others replaced by None)."""
    return tree_map(lambda x, m: x if m else None, tree, mask)


def razor_bytes_formula(phi: int, dp: int) -> int:
    """Paper's Adam arithmetic: unique bytes per DP group = 12*phi/d per device
    (fp32 master + m + v, each 4 bytes, ZeRO-sharded d ways)."""
    return 12 * phi // max(dp, 1)
