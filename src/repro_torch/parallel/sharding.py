"""Sharding rules: DP / TP / EP / SP over the ("pod", "data", "model") mesh
(port of ``repro.parallel.sharding``).

Rules are name+shape based over the param tree (the reference's layout,
``repro_torch.tree``, layers stacked on a leading axis):

  * TP ("model"):  attention q-heads, kv-heads (when divisible), FFN hidden,
    MoE experts (EP), Mamba2 inner/heads, vocab dim of embeddings.
  * DP ("pod","data"): the batch dim of activations and caches.
  * ZeRO-1 ("data"): optimizer master/m/v leaves get "data" inserted into the
    first still-unsharded, divisible dim.
  * SP: decode KV caches shard the *sequence* dim over "model" (and over
    "data" too when the batch dim can't use it — long_500k batch=1).

Every rule degrades to replication when a dim isn't divisible (e.g. gemma-2b's
8 q-heads on a 16-way model axis) — documented fallback, not an error.

The rules are pure functions of names and shapes, ported whole, the "model"
axis included; they take any mesh with ``axis_names`` and a ``shape`` dict
(``repro_torch.launch.mesh.Mesh``) and any leaf with a ``.shape``. A spec is
the port's own ``P``. Where the reference lets XLA place the blocks,
``local_block`` cuts this rank's block out of a full tensor and
``join_tree`` puts the blocks back together, as a ``NamedSharding``
places them: contiguous equal blocks in rank order along each named axis,
the first of several axes named on one dim the major one.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.tree import (Stacked, tree_flatten, tree_map, tree_map_with_path,
                              tree_unflatten)

PyTree = Any


def _part(p):
    """One entry of a spec as JAX normalizes it: a tuple of one name is the
    name, an empty one None."""
    if isinstance(p, (list, tuple)):
        p = tuple(p)
        return p[0] if len(p) == 1 else (p or None)
    return p


class P:
    """A PartitionSpec: one entry per leading dim of a leaf, each an axis
    name, a tuple of axis names, or None (not sharded); dims past the last
    entry are not sharded. Immutable, and a leaf of the port's trees."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        object.__setattr__(self, "parts", tuple(_part(p) for p in parts))

    def __setattr__(self, name, value):
        raise AttributeError("P is immutable")

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.parts == other.parts

    def __hash__(self) -> int:
        return hash(("P", self.parts))

    def __repr__(self) -> str:
        return f"P{self.parts!r}"


def is_spec(x) -> bool:
    """The ``is_leaf`` of a tree of specs whose None leaves are leaves."""
    return isinstance(x, P) or x is None


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    return int(np.prod([axis_size(mesh, a) for a in batch_axes(mesh)]))


def _div(n: int, d: int) -> bool:
    return d > 0 and n % d == 0 and n >= d


def _keys(path) -> list:
    return [str(k) for k in path]


# --------------------------------------------------------------------------- #
# Parameter specs
# --------------------------------------------------------------------------- #
def _leaf_spec(name: str, shape: Tuple[int, ...], cfg: ArchConfig,
               tp: int, stacked: bool) -> P:
    """PartitionSpec for one (unstacked) param leaf; `stacked` prepends None."""
    base = shape[1:] if stacked else shape
    h, kh = cfg.num_heads, cfg.num_kv_heads

    def spec(*parts):
        out = (None,) + parts if stacked else parts
        return P(*out)

    if name == "w" and len(base) == 2:  # embed / lm_head (V, D)
        return spec("model" if _div(base[0], tp) else None, None)
    if name in ("wq",):
        return spec(None, "model" if _div(h, tp) else None)
    if name in ("wk", "wv"):
        return spec(None, "model" if _div(kh, tp) else None)
    if name == "wo":
        return spec("model" if _div(h, tp) else None, None)
    if name in ("w_gate", "w_up") and len(base) == 3:  # MoE experts (E, D, F)
        return spec("model" if _div(base[0], tp) else None, None, None)
    if name == "w_down" and len(base) == 3:
        return spec("model" if _div(base[0], tp) else None, None, None)
    if name in ("w_gate", "w_up") and len(base) == 2:  # dense MLP (D, F)
        return spec(None, "model" if _div(base[1], tp) else None)
    if name == "w_down" and len(base) == 2:            # (F, D)
        return spec("model" if _div(base[0], tp) else None, None)
    if name == "router":
        return spec(None, None)
    # --- Mamba2 ---
    if name in ("w_x", "w_z"):  # (D, inner) — inner is head-major
        return spec(None, "model" if _div(cfg.ssm_heads, tp) else None)
    if name == "w_dt":          # (D, H)
        return spec(None, "model" if _div(cfg.ssm_heads, tp) else None)
    if name in ("w_b", "w_c"):  # (D, N) — single SSD group, replicated
        return spec(None, None)
    if name == "conv_x":        # (inner, k)
        return spec("model" if _div(cfg.ssm_heads, tp) else None, None)
    if name in ("conv_b", "conv_c"):
        return spec(None, None)
    if name in ("a_log", "d_skip", "dt_bias"):  # (H,)
        return spec("model" if _div(cfg.ssm_heads, tp) else None)
    if name == "norm":          # (inner,)
        return spec("model" if _div(cfg.ssm_heads, tp) else None)
    if name == "out":           # (inner, D)
        return spec("model" if _div(cfg.ssm_heads, tp) else None, None)
    # norms / small vectors / shared_gate
    return spec(*([None] * len(base)))


_STACKED_ROOTS = ("blocks", "encoder", "decoder")


def param_pspecs(cfg: ArchConfig, specs: PyTree, mesh, *, fsdp: bool = False) -> PyTree:
    """TP specs; with fsdp=True every leaf additionally shards its first
    free divisible dim over "data" (ZeRO-3 / fully-sharded storage; the
    layer bodies gather their leaves, ``models.modes.unshard_layer_params``)."""
    tp = axis_size(mesh, "model")
    dz = axis_size(mesh, "data")

    def rule(path, leaf):
        keys = _keys(path)
        stacked = any(k in _STACKED_ROOTS for k in keys)
        spec = _leaf_spec(keys[-1], tuple(leaf.shape), cfg, tp, stacked)
        # embeddings stay TP-only: FSDP-sharding the (V, D) tables makes the
        # logits product contract over a "data"-sharded dim, which the
        # reference measured as a ~250 GB/device regression.
        if fsdp and keys[0] not in ("embed", "lm_head"):
            spec = zero_spec(spec, tuple(leaf.shape), dz, "data")
        return spec

    return tree_map_with_path(rule, specs)


# --------------------------------------------------------------------------- #
# ZeRO-1: optimizer-state sharding over "data"
# --------------------------------------------------------------------------- #
def zero_spec(spec: P, shape: Tuple[int, ...], zero: int, axis: str = "data") -> P:
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for p in parts:  # already sharded over `axis` (e.g. FSDP params): no-op
        if p == axis or (isinstance(p, tuple) and axis in p):
            return P(*parts)
    for i, (p, n) in enumerate(zip(parts, shape)):
        if p is None and _div(n, zero):
            parts[i] = axis
            return P(*parts)
    return P(*parts)  # nothing divisible: stays unsharded on `axis` (tiny leaf)


def zero_pspecs(pspecs: PyTree, specs: PyTree, mesh, axis: str = "data") -> PyTree:
    z = axis_size(mesh, axis)
    return tree_map(lambda p, s: zero_spec(p, tuple(s.shape), z, axis), pspecs, specs)


def sharded_dim(spec: P, axis: str = "data"):
    """The dim that ``spec`` shards over ``axis``, or None."""
    for i, part in enumerate(spec):
        if part == axis or (isinstance(part, tuple) and axis in part):
            return i
    return None


# --------------------------------------------------------------------------- #
# Input / cache / activation specs
# --------------------------------------------------------------------------- #
def input_pspecs(cfg: ArchConfig, specs: Dict, mesh) -> Dict:
    dp = batch_axes(mesh)
    dpn = dp_size(mesh)

    def rule(path, leaf):
        keys = _keys(path)
        if "cache" in keys:
            return _cache_leaf_spec(keys, leaf, cfg, mesh)
        b = leaf.shape[0]
        lead = dp if _div(b, dpn) else None
        return P(lead, *([None] * (len(leaf.shape) - 1)))

    return tree_map_with_path(rule, specs)


def _cache_leaf_spec(keys, leaf, cfg: ArchConfig, mesh) -> P:
    dp = batch_axes(mesh)
    dpn = dp_size(mesh)
    tp = axis_size(mesh, "model")
    name = keys[-1]
    if name == "index":
        return P()
    if name in ("k", "v", "cross_k", "cross_v"):
        _, b, t, kh, _ = leaf.shape
        b_ax = dp if _div(b, dpn) else None
        # SP: sequence over "model"; if batch idle, use ("data","model")
        if b_ax is None and _div(t, dpn * tp):
            t_ax: Any = tuple(a for a in ("pod", "data", "model")
                              if a in mesh.axis_names)
        elif _div(t, tp):
            t_ax = "model"
        else:
            t_ax = None
        return P(None, b_ax, t_ax, None, None)
    # mamba decode state
    if name == "ssm":            # (L, B, H, N, P)
        _, b, h, _, _ = leaf.shape
        return P(None, dp if _div(b, dpn) else None,
                 "model" if _div(h, tp) else None, None, None)
    if name in ("conv_x",):      # (L, B, k-1, inner)
        _, b, _, inner = leaf.shape
        return P(None, dp if _div(b, dpn) else None, None,
                 "model" if _div(cfg.ssm_heads, tp) else None)
    if name in ("conv_b", "conv_c"):
        _, b, _, _ = leaf.shape
        return P(None, dp if _div(b, dpn) else None, None, None)
    raise ValueError(f"unknown cache leaf {keys}")


def cache_pspecs(cfg: ArchConfig, cache_specs: PyTree, mesh) -> PyTree:
    def rule(path, leaf):
        return _cache_leaf_spec(["cache"] + _keys(path), leaf, cfg, mesh)

    return tree_map_with_path(rule, cache_specs)


# --------------------------------------------------------------------------- #
# Blocks of a sharded tensor
# --------------------------------------------------------------------------- #
def _names(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def block_slices(spec: P, shape: Tuple[int, ...], mesh, coords=None):
    """(dim, start, length) of the block that the rank at ``coords`` (this
    rank's by default) holds, for each dim that ``spec`` shards."""
    coords = mesh.coords if coords is None else coords
    out = []
    for dim, part in enumerate(spec):
        names = _names(part)
        if not names:
            continue
        n = math.prod(mesh.shape[a] for a in names)
        i = 0
        for a in names:
            i = i * mesh.shape[a] + (coords[a] if coords else 0)
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {shape} does not split {n} ways ({spec})")
        size = shape[dim] // n
        out.append((dim, i * size, size))
    return out


def block_shape(spec: P, shape: Tuple[int, ...], mesh) -> Tuple[int, ...]:
    out = list(shape)
    for dim, _, size in block_slices(spec, tuple(shape), mesh):
        out[dim] = size
    return tuple(out)


def _full(leaf) -> torch.Tensor:
    if isinstance(leaf, Stacked):
        return torch.stack([t.detach() for t in leaf.layers])
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(leaf)
    return leaf.detach()


def local_block(x, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the full leaf ``x`` (a tensor, a ``Stacked``
    leaf or a numpy array), a view where ``x`` is a tensor."""
    x = _full(x)
    for dim, start, size in block_slices(spec, tuple(x.shape), mesh):
        x = x.narrow(dim, start, size)
    return x


@torch.no_grad()
def join_tree(tree: PyTree, pspecs: PyTree, mesh) -> PyTree:
    """The full tensors of a tree of this rank's blocks (every rank gets
    them): each leaf's blocks gathered from every rank of the mesh and put
    back in place. Where ranks hold copies of a block, the lowest rank's is
    taken; a None leaf stays None. A collective: every rank calls it with
    the same tree."""
    leaves, treedef = tree_flatten(tree, lambda x: x is None)
    specs = tree_flatten(pspecs, is_spec)[0]
    out = []
    for x, spec in zip(leaves, specs):
        if x is None:
            out.append(None)
            continue
        blocks = mesh.all_gather(x[None], tuple(mesh.axis_names), 0) \
            if mesh.size > 1 else x[None]
        shape = list(x.shape)
        for dim, part in enumerate(spec):
            shape[dim] *= math.prod(mesh.shape[a] for a in _names(part))
        full = x.new_empty(shape)
        filled = set()
        for rank in range(mesh.size):
            where = tuple(block_slices(spec, tuple(shape), mesh, mesh.coords_of(rank)))
            if where in filled:
                continue
            filled.add(where)
            view = full
            for dim, start, size in where:
                view = view.narrow(dim, start, size)
            view.copy_(blocks[rank])
        out.append(full)
    return tree_unflatten(treedef, out)
