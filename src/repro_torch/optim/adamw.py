"""AdamW on an fp32 master, m and v (port of ``repro.optim.adamw``):
global-norm clipping, bias correction, decoupled weight decay on the master.

Trees are the reference's layout (``repro_torch.tree``; per-layer tensors
inside ``Stacked`` leaves), and the update runs on their tensors with
PyTorch's multi-tensor (``_foreach``) operations on the state's device. It
updates the optimizer state in place, where the reference returns new
arrays and lets XLA reuse the donated buffers: the result is the same and
no second copy of master, m and v is allocated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import map_tensors, tensors

PyTree = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def adamw_init(params: PyTree) -> Dict[str, PyTree]:
    """fp32 master (a copy of the params) and zero m and v, in the params'
    layout and on their device."""
    return {
        "master": map_tensors(lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": map_tensors(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params),
        "v": map_tensors(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params),
    }


def _norm(ts) -> torch.Tensor:
    return torch.sqrt(torch.stack(torch._foreach_norm(ts)).square().sum())


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return _norm([t.float() for t in tensors(tree)])


@torch.no_grad()
def adamw_update(grads: PyTree, opt: Dict[str, PyTree], step: torch.Tensor,
                 hp: AdamWConfig, lr: torch.Tensor) -> Tuple[PyTree, Dict[str, PyTree]]:
    """One step on ``opt`` = {"master", "m", "v"}, in place. ``step`` is the
    step count before this update (0-d), ``lr`` this step's rate (0-d).
    Returns (master, opt) as the reference does; the caller casts the
    params (``cast_params``)."""
    g = [t.float() for t in tensors(grads)]
    master, m, v = (list(tensors(opt[k])) for k in ("master", "m", "v"))
    if not len(g) == len(master) == len(m) == len(v):
        raise ValueError("grads and optimizer state hold different numbers of tensors")
    gnorm = _norm(g)
    scale = torch.clamp(hp.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(hp.b1, t)
    bc2 = 1.0 - torch.pow(hp.b2, t)

    g = torch._foreach_mul(g, scale)
    torch._foreach_mul_(m, hp.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - hp.b1))
    g2 = torch._foreach_mul(g, g)
    del g
    torch._foreach_mul_(g2, 1.0 - hp.b2)
    torch._foreach_mul_(v, hp.b2)
    torch._foreach_add_(v, g2)
    del g2
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, hp.eps)
    update = torch._foreach_div(m, bc1)
    torch._foreach_div_(update, denom)
    del denom
    torch._foreach_add_(update, torch._foreach_mul(master, hp.weight_decay))
    torch._foreach_mul_(update, lr)
    torch._foreach_sub_(master, update)
    return opt["master"], opt


@torch.no_grad()
def cast_params(master: PyTree, like: PyTree) -> PyTree:
    """Write the master into the params ``like`` in place, cast to each
    param's dtype. Returns ``like``."""
    for p, m in zip(tensors(like), tensors(master)):
        p.copy_(m)
    return like
