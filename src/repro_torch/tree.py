"""Pytree utilities in ``jax.tree_util``'s order, for the port's training
state and checkpoints.

A tree is nested dicts, lists and tuples; ``None`` is an empty subtree and
anything else is a leaf, as in JAX. Dict keys are visited in sorted order,
as ``jax.tree_util`` visits them (``torch.utils._pytree`` keeps insertion
order instead), so the flattened optimizer vector, the ``.npz`` keys and the
chunk-stream manifests come out as the reference's.

The port keeps one module per layer where the reference stacks each layer
parameter on a leading L axis (``lax.scan``). ``layered`` gives the
reference's view of a name-keyed parameter dict without copying: the
per-layer tensors of one parameter become one ``Stacked`` leaf, which
``to_numpy`` stacks only when it copies to the host, where the copy happens
anyway.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

PyTree = Any
SEP = "|"                     # key-path separator of the .npz keys and manifests


class Stacked:
    """One leaf: the per-layer tensors of one parameter, seen as a single
    array stacked on a leading layer axis. Holds references, copies nothing."""

    __slots__ = ("layers",)

    def __init__(self, layers: Sequence[torch.Tensor]):
        if not layers:
            raise ValueError("a Stacked leaf needs at least one layer")
        self.layers = list(layers)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.layers),) + tuple(self.layers[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.layers[0].dtype


def _is_node(x) -> bool:
    return x is None or isinstance(x, (Mapping, list, tuple))


def _children(node) -> List[Tuple[Any, Any]]:
    """(key, child) pairs in jax.tree_util's order."""
    if node is None:
        return []
    if isinstance(node, Mapping):
        return [(k, node[k]) for k in sorted(node)]
    return list(enumerate(node))


class _Leaf:
    """The place of a leaf in a treedef."""


_LEAF = _Leaf()


def tree_flatten_with_path(tree: PyTree, is_leaf: Optional[Callable] = None
                           ) -> List[Tuple[Tuple, Any]]:
    """[(key path, leaf)] in jax.tree_util's order; ``is_leaf`` (as in
    ``jax.tree_util``) stops the walk at the nodes it accepts, ``None``
    included."""
    out: List[Tuple[Tuple, Any]] = []

    def walk(node, path):
        if not _is_node(node) or (is_leaf is not None and is_leaf(node)):
            out.append((path, node))
            return
        for key, child in _children(node):
            walk(child, path + (key,))

    walk(tree, ())
    return out


def tree_flatten(tree: PyTree, is_leaf: Optional[Callable] = None
                 ) -> Tuple[List[Any], PyTree]:
    """(leaves, treedef): the treedef is the tree with every leaf replaced
    by a placeholder, for ``tree_unflatten``."""
    def strip(node):
        if not _is_node(node) or (is_leaf is not None and is_leaf(node)):
            return _LEAF
        if node is None:
            return None
        if isinstance(node, Mapping):
            return {k: strip(node[k]) for k in sorted(node)}
        return type(node)(strip(c) for c in node)

    return [leaf for _, leaf in tree_flatten_with_path(tree, is_leaf)], strip(tree)


def tree_unflatten(treedef: PyTree, leaves: Sequence[Any]) -> PyTree:
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        if node is None:
            return None
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        return type(node)(build(c) for c in node)

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the treedef has places")
    return out


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree,
             is_leaf: Optional[Callable] = None) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), ``is_leaf`` as in
    ``tree_flatten``."""
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [tree_flatten(r, is_leaf) for r in rest]
    for r_leaves, r_def in others:
        if r_def != treedef:
            raise ValueError("tree_map over trees of different structures")
    return tree_unflatten(treedef, [fn(*args) for args in
                                    zip(leaves, *(r for r, _ in others))])


def tree_map_with_path(fn: Callable, tree: PyTree) -> PyTree:
    """``fn(key path, leaf)`` over the leaves of ``tree``."""
    flat = tree_flatten_with_path(tree)
    return tree_unflatten(tree_flatten(tree)[1], [fn(path, leaf) for path, leaf in flat])


def keystr(path: Tuple) -> str:
    """A key path as the reference's .npz key: ``opt|m|blocks|attn|wq``."""
    return SEP.join(str(k) for k in path)


def tensors(tree: PyTree) -> Iterator[torch.Tensor]:
    """Every tensor of the tree in order, a ``Stacked`` leaf layer by layer."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, Stacked):
            yield from leaf.layers
        else:
            yield leaf


def map_tensors(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over matching tensors, layer by layer inside ``Stacked``
    leaves, which stay ``Stacked``."""
    def one(leaf, *others):
        if isinstance(leaf, Stacked):
            return Stacked([fn(*ts) for ts in zip(leaf.layers, *(o.layers for o in others))])
        return fn(leaf, *others)

    return tree_map(one, tree, *rest)


def layered(named: Mapping[str, torch.Tensor]) -> Dict:
    """The reference's tree of a name-keyed parameter dict (as
    ``named_parameters()`` gives it): ``embed.w`` becomes
    ``{"embed": {"w": ...}}`` and ``blocks.<i>.<rest>`` the layer-``i`` entry
    of one ``Stacked`` leaf at ``("blocks", *rest)``."""
    tree: Dict = {}
    stacks: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            stacks.setdefault(("blocks",) + tuple(parts[2:]), {})[int(parts[1])] = t
        else:
            _insert(tree, tuple(parts), t)
    for path, by_layer in stacks.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{'.'.join(path)}: layers {sorted(by_layer)} are not 0..L-1")
        _insert(tree, path, Stacked([by_layer[i] for i in range(len(by_layer))]))
    return tree


def _insert(tree: Dict, path: Tuple[str, ...], leaf) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    if path[-1] in node:
        raise ValueError(f"two leaves at {'.'.join(path)}")
    node[path[-1]] = leaf


# --------------------------------------------------------------------------- #
# Host copies
# --------------------------------------------------------------------------- #
def _bf16_numpy_dtype() -> np.dtype:
    """bf16 on the host: ``ml_dtypes.bfloat16`` (what the reference's arrays
    hold) where that package is installed, else the uint16 bit pattern.
    Both hold the same bytes."""
    try:
        import ml_dtypes
    except ImportError:
        return np.dtype(np.uint16)
    return np.dtype(ml_dtypes.bfloat16)


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype that ``to_numpy`` gives a tensor of ``dtype``."""
    if dtype == torch.bfloat16:
        return _bf16_numpy_dtype()
    return torch.empty((), dtype=dtype).numpy().dtype


def _copy_to_host(dst: np.ndarray, src: torch.Tensor) -> None:
    """``dst[...] = src`` into a host array of ``host_dtype(src.dtype)``."""
    src = src.detach()
    if src.dtype == torch.bfloat16:
        torch.from_numpy(dst.view(np.int16)).copy_(src.view(torch.int16))
    else:
        torch.from_numpy(dst).copy_(src)


def to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array: a tensor copied off its device, a
    ``Stacked`` leaf stacked on axis 0, anything else through
    ``np.asarray`` (a numpy array is returned as it is, not copied)."""
    if isinstance(leaf, Stacked):
        out = np.empty(leaf.shape, dtype=host_dtype(leaf.dtype))
        for i, t in enumerate(leaf.layers):
            _copy_to_host(out[i], t)
        return out
    if isinstance(leaf, torch.Tensor):
        out = np.empty(tuple(leaf.shape), dtype=host_dtype(leaf.dtype))
        _copy_to_host(out, leaf)
        return out
    return np.asarray(leaf)


def _from_host(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(arr, order="C")
    if not arr.flags.writeable:        # torch.from_numpy wants a writable buffer
        arr = arr.copy()
    if dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and arr.dtype.kind != "f":
        # bf16 bits (ml_dtypes' bfloat16 or uint16): reinterpret, no rounding
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr).to(dtype)


@torch.no_grad()
def copy_from_numpy_(tree: PyTree, host: PyTree) -> None:
    """Write the host tree ``host`` (numpy leaves, the structure of
    ``tree``) into the tensors of ``tree`` in place, cast to each tensor's
    dtype; a ``Stacked`` leaf takes one layer of the array each."""
    leaves, treedef = tree_flatten(tree)
    arrays, host_def = tree_flatten(host)
    if host_def != treedef:
        raise ValueError("the host tree's structure differs from the tree's")
    for leaf, arr in zip(leaves, arrays):
        if tuple(np.shape(arr)) != tuple(leaf.shape):
            raise ValueError(f"host shape {np.shape(arr)} != {tuple(leaf.shape)}")
        if isinstance(leaf, Stacked):
            for i, t in enumerate(leaf.layers):
                t.copy_(_from_host(arr[i], t.dtype))
        else:
            leaf.copy_(_from_host(arr, leaf.dtype))
