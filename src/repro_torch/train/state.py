"""Training state (port of ``repro.train.state.init_state``): the step
count, the params and the AdamW state, as a tree in the reference's layout
(``repro_torch.tree``). There is no ``StatePlan``: one device, no
PartitionSpecs.

The params are the model's own parameters (``Stacked`` leaves hold each
layer's tensor), so the state and the model never diverge; master, m and v
are fp32 tensors of the same layout on the same device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.optim import adamw_init
from repro_torch.tree import layered

PyTree = Any


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
