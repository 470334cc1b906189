"""Shared layers: norms, RoPE, MLP flavors, embeddings (port of
``repro.models.layers``).

Plain functions on tensors; weights keep the JAX layout (``x @ w`` with
``w`` of shape (in, out), embeddings (V, D)). Compute runs in the tensor's
dtype with fp32 where the reference uses it (norm statistics, RoPE, logits).
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm scaled by ``1 + scale`` (norm weights are initialised to 0)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Qwen3-style qk-norm over the head dim of (..., heads, head_dim)."""
    return rms_norm(x, scale, eps)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Computed in numpy float32, exactly as the reference does."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_frequencies_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The frequencies, copied to ``device`` once: a copy from pageable host
    memory on every call would wait for the device each time."""
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half (NeoX) rotary embedding. x: (..., seq, heads, head_dim);
    positions: (..., seq) integers."""
    dtype = x.dtype
    freqs = _rope_frequencies_on(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs       # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
    if mlp_type == "geglu":
        return (F.gelu(x @ params["w_gate"], approximate="tanh")
                * (x @ params["w_up"])) @ params["w_down"]
    if mlp_type == "sq_relu":
        return F.relu(x @ params["w_up"]).square() @ params["w_down"]
    if mlp_type == "gelu":
        return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]
    raise ValueError(f"unknown mlp_type {mlp_type!r}")


def embed_init(generator: torch.Generator, vocab: int, d_model: int, dtype) -> torch.Tensor:
    """N(0, 0.02) table on the generator's device, as the reference."""
    w = torch.randn(vocab, d_model, generator=generator, device=generator.device)
    return (w * 0.02).to(dtype)


def mlp_init(generator: torch.Generator, p: Dict[str, torch.Tensor], d_model: int,
             d_ff: int) -> None:
    """Fill MLP weights in place with the reference's distributions."""
    scales = {"w_gate": 1.0 / np.sqrt(d_model), "w_up": 1.0 / np.sqrt(d_model),
              "w_down": 1.0 / np.sqrt(d_ff)}
    for name in ("w_gate", "w_up", "w_down"):
        if name in p:
            w = p[name]
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=generator.device) * scales[name])


def embed_lookup(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return w[tokens]


def unembed(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits over the (padded) vocabulary: bf16 operands, fp32
    accumulation and output, as the reference's ``preferred_element_type``.
    On CUDA one ``mm`` with ``out_dtype`` does it without an fp32 copy of the
    (V, D) table; the CPU has no such ``mm``, and there the operands are
    upcast (exact: every bf16 value is an fp32 value)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype != torch.float32:
        logits = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        logits = x2.float() @ w.float().t()
    return logits.reshape(*lead, w.shape[0])
