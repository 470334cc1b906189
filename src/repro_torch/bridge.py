"""Load the JAX package's parameters into the port.

The caller hands over the reference's parameter tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``), with the layers stacked
on a leading L axis as ``lax.scan`` keeps them. This module itself never
imports jax.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import build_model
from repro_torch.tree import STACKED_ROOTS


def _leaf(tree: Mapping, path) -> np.ndarray:
    node = tree
    for key in path:
        if not isinstance(node, Mapping) or key not in node:
            raise KeyError(f"parameter tree has no {'.'.join(path)}")
        node = node[key]
    return node


def _count_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


@torch.no_grad()
def params_from_numpy(tree: Mapping, cfg: ArchConfig, device=None,
                      dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """The port's model for ``cfg.family`` (``DecoderLM`` for dense, MoE and
    VLM configs, ``MambaLM``, ``HybridLM``, whose ``shared_attn`` leaves are
    not stacked, or ``EncDecLM``, whose ``encoder`` and ``decoder`` are) on
    ``device`` (CUDA by default) holding the reference's
    weights, cast to each parameter's dtype: ``dtype`` (the config's by
    default), except the leaves the model keeps in fp32 whatever its dtype
    (the Mamba2 block's ``a_log``, ``d_skip``, ``dt_bias``; the MoE layer's
    ``router`` and ``shared_gate``, beside its nested ``shared`` MLP), which
    the reference keeps in fp32 too. bf16 arrays (``ml_dtypes``) are widened to fp32 on the way, which
    is exact."""
    model = build_model(cfg, device=device, dtype=dtype)
    used = set()
    for name, param in model.named_parameters():
        parts = name.split(".")
        if parts[0] in STACKED_ROOTS:
            path = (parts[0],) + tuple(parts[2:])
            arr = np.asarray(_leaf(tree, path))[int(parts[1])]
        else:
            path = tuple(parts)
            arr = np.asarray(_leaf(tree, path))
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {arr.shape} != port shape "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
        used.add(path)
    if len(used) != _count_leaves(tree):
        raise ValueError(f"parameter tree has {_count_leaves(tree)} leaves, the port "
                         f"uses {len(used)}: the trees differ")
    return model
