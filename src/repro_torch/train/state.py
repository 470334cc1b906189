"""Training state (port of ``repro.train.state``): the step count, the
params and the AdamW state, as a tree in the reference's layout
(``repro_torch.tree``), with the matching PartitionSpec trees.

On one device (``init_state``, the simulated cluster's) the params are the
model's own parameters (``Stacked`` leaves hold each layer's tensor), so the
state and the model never diverge; master, m and v are fp32 tensors of the
same layout on the same device.

On a mesh (``train.step.build_train_step``) each rank holds its blocks of
the reference's global arrays, layers stacked on a leading axis: params by
``StatePlan.param_pspecs`` (TP, and FSDP over "data" where asked), master,
m and v by the ZeRO-1 ``opt_pspecs`` (``shard_init_state``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.optim import adamw_init
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P
from repro_torch.tree import layered, map_tensors, tensors, tree_map

PyTree = Any


@dataclass(frozen=True)
class StatePlan:
    """Shapes + shardings of the full train state."""
    state_specs: PyTree       # meta tensors of the global shapes and dtypes
    state_pspecs: PyTree      # PartitionSpecs
    param_pspecs: PyTree
    opt_pspecs: PyTree        # ZeRO-1 specs for master/m/v


def _meta(leaf) -> torch.Tensor:
    return torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device="meta")


def make_state_specs(model: torch.nn.Module) -> PyTree:
    """The train state's global shapes and dtypes as meta tensors (layers
    stacked on a leading axis); allocates nothing."""
    param_specs = tree_map(_meta, param_tree(model))
    return {
        "step": torch.empty((), dtype=torch.int32, device="meta"),
        "params": param_specs,
        "opt": adamw_init(param_specs),
    }


def make_state_plan(model: torch.nn.Module, mesh, *, fsdp_params: bool = False) -> StatePlan:
    cfg = model.cfg
    state_specs = make_state_specs(model)
    param_pspecs = shd.param_pspecs(cfg, state_specs["params"], mesh, fsdp=fsdp_params)
    opt_pspecs = {
        k: shd.zero_pspecs(param_pspecs, state_specs["params"], mesh)
        for k in ("master", "m", "v")
    }
    state_pspecs = {"step": P(), "params": param_pspecs, "opt": opt_pspecs}
    return StatePlan(state_specs, state_pspecs, param_pspecs, opt_pspecs)


@torch.no_grad()
def shard_init_state(params: PyTree, plan: StatePlan, mesh, device=None) -> PyTree:
    """This rank's blocks of ``init_state``'s state for the full ``params``
    (a tree in the reference's layout: ``Stacked`` leaves, tensors or numpy
    arrays), on ``device`` (the params' by default): the params' blocks in
    their dtype, the master's blocks in fp32 and zero m and v. The full
    optimizer state is never built."""
    local = shard_params(params, plan, mesh, device)
    master = tree_map(lambda x, spec: _block(x, spec, torch.float32, mesh, device), params,
                      plan.opt_pspecs["master"])
    step_device = next(iter(tensors(local))).device
    return {"step": torch.zeros((), dtype=torch.int32, device=step_device),
            "params": local,
            "opt": {"master": master, "m": map_tensors(torch.zeros_like, master),
                    "v": map_tensors(torch.zeros_like, master)}}


def _block(x, spec, dtype, mesh, device) -> torch.Tensor:
    b = shd.local_block(x, spec, mesh)
    return b.to(device=device, dtype=dtype, copy=True).contiguous()


@torch.no_grad()
def shard_params(params: PyTree, plan: StatePlan, mesh, device=None) -> PyTree:
    """This rank's blocks of the full ``params`` (as ``shard_init_state``
    takes them) by ``plan.param_pspecs``, in the params' dtypes, contiguous,
    on ``device``: what the mesh's serve steps take."""
    dtypes = tree_map(lambda s: s.dtype, plan.state_specs["params"])
    return tree_map(lambda x, spec, dtype: _block(x, spec, dtype, mesh, device),
                    params, plan.param_pspecs, dtypes)


def param_tree(model: torch.nn.Module) -> Dict:
    """The model's parameters in the reference's tree (no copies)."""
    return layered(dict(model.named_parameters()))


def grad_tree(model: torch.nn.Module) -> Dict:
    """The parameters' ``.grad`` in the reference's tree."""
    return layered({name: p.grad for name, p in model.named_parameters()})


def init_state(model: torch.nn.Module, generator: torch.Generator) -> PyTree:
    """Initialise ``model`` from ``generator``, make its parameters
    trainable and return {"step": int32 0-d, "params", "opt"} on its
    device."""
    model.init(generator)
    model.requires_grad_(True)
    params = param_tree(model)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
        "params": params,
        "opt": adamw_init(params),
    }
