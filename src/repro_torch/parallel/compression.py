"""Cross-pod gradient compression (port of ``repro.parallel.compression``).

The inter-pod hop is the scarcest bandwidth in a multi-pod job: a full
all-reduce of the gradients crosses it every step. Here the cross-pod stage
is quantized to int8 with a shared per-leaf scale, a 2x payload reduction
against bf16 (4x against fp32) on that hop.

Error feedback keeps quantization bias bounded: each rank folds its local
quantization residual back into the returned mean (stateless form: the
residual re-enters the same step's optimizer update rather than a carried
buffer), so each pod's mean differs from the others' by its own residual,
as in the reference. The quantized values are summed in fp32, as the
reference sums them: int8 sums would overflow.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

PyTree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def pod_compressed_mean(grads: Sequence[torch.Tensor], mesh, axis: str = "pod"
                        ) -> List[torch.Tensor]:
    """The mean over ``axis`` of each rank's ``grads`` (each a pod's mean,
    whole or as this rank's block of it), as the reference's ``reduce_one``
    computes it: a scale shared by all pods (the largest magnitude of the
    whole leaf, a MAX over the pod and data ranks), q = clip(round(g / s),
    -127, 127) in fp32, the fp32 sum of q over the pods (one collective for
    every leaf), plus this rank's residual g - q s over the pod count."""
    npods = mesh.shape.get(axis, 1)
    if npods <= 1:
        return list(grads)
    xf = [g.float() for g in grads]
    local_max = torch.stack([torch.clamp(x.abs().max(), min=1e-12) for x in xf])
    scale_axes = tuple(a for a in (axis, "data") if a in mesh.axis_names)
    scales = mesh.all_reduce(local_max, scale_axes, op=dist.ReduceOp.MAX) / 127.0
    q = [torch.clamp(torch.round(x / s), -127, 127) for x, s in zip(xf, scales)]
    qsum = mesh.all_reduce(torch.cat([t.reshape(-1) for t in q]), axis)
    out = []
    for g, x, qi, s, total in zip(grads, xf, q, scales,
                                  qsum.split([t.numel() for t in q])):
        mean = total.view(x.shape) * s / npods
        resid = x - qi * s                               # local quantization error
        out.append((mean + resid / npods).to(g.dtype))
    return out


def pod_compressed_value_and_grad(value_and_grad: Callable, mesh, axis: str = "pod"):
    """Returns fn(*args) -> ((loss, aux), grads) where the cross-pod
    reduction of the gradients is the int8-quantized sum with error
    feedback of ``pod_compressed_mean`` and the loss and ``aux`` are
    averaged over the pods.

    The reference wraps a loss function and leaves the in-pod ("data")
    reduction to XLA inside its ``shard_map``; eager PyTorch reduces
    explicitly, so this wraps ``value_and_grad(*args) -> ((loss, aux),
    grads)``, which returns this pod's means (``grads`` a sequence of
    tensors, whole or this rank's blocks)."""
    npods = mesh.shape.get(axis, 1)

    def fn(*args):
        (loss, aux), grads = value_and_grad(*args)
        if npods <= 1:
            return (loss, aux), grads
        grads = pod_compressed_mean(grads, mesh, axis)
        keys = sorted(aux)
        vals = mesh.all_reduce(torch.stack([loss] + [aux[k] for k in keys]), axis) / npods
        return (vals[0], dict(zip(keys, vals[1:]))), grads

    return fn


def compressed_bytes_saved(grad_bytes: int, npods: int) -> Tuple[int, int]:
    """(bf16 cross-pod payload, int8 payload) per step per device."""
    if npods <= 1:
        return 0, 0
    return grad_bytes, grad_bytes // 2
