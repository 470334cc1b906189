"""Shared layers: norms, RoPE, sinusoidal positions, MLP flavors, embeddings, the chunked
cross-entropy and the gradient barrier (port of ``repro.models.layers``).

Plain functions on tensors; weights keep the JAX layout (``x @ w`` with
``w`` of shape (in, out), embeddings (V, D)). Compute runs in the tensor's
dtype with fp32 where the reference uses it (norm statistics, RoPE, logits).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.modes import (analysis_form, current_tp, seq_scatter,
                                      sequence_split, tp_copy, tp_reduce)


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


def sinusoidal_positions(seq: int, d_model: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal embeddings for encoder frames, (seq,
    d_model), computed in numpy exactly as the reference does (float64)."""
    pos = np.arange(seq, dtype=np.float32)[:, None]
    dim = np.arange(d_model // 2, dtype=np.float32)[None, :]
    inv = np.exp(-np.log(10_000.0) * dim / max(d_model // 2 - 1, 1))
    ang = pos * inv
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


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


def embed_lookup(w: torch.Tensor, tokens: torch.Tensor, vocab: Optional[int] = None,
                 prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rows of ``w`` (V, D) at ``tokens``, behind ``prefix`` (B, P, D)
    where given (a VLM's patch embeddings, cast to ``w``'s dtype). Where
    ``w`` has fewer rows than ``vocab`` it is this rank's block of a
    vocab-parallel table (under ``modes.tensor_parallel``): the tokens
    outside its rows look up zeros, and the sum over the ranks
    (``tp_reduce``) gives every rank the rows; the prefix is put in front
    after the sum. Under sequence parallelism the result is this rank's
    block of the positions of [prefix | tokens]: the sum is a reduce-scatter
    of the whole sequence (``seq_scatter``), to which the rank at "model"
    index 0 gives the prefix and the others zeros there (so the sum is
    exact), and a whole table's sequence is cut to the block."""
    split = vocab is not None and w.shape[0] != vocab
    if not split:
        x = w[tokens]
    else:
        rows = w.shape[0]
        local = tokens - current_tp().index * rows
        own = (local >= 0) & (local < rows)
        x = torch.where(own[..., None], w[local.clamp(0, rows - 1)], 0)
    if prefix is not None:
        prefix = prefix.to(x.dtype)
    if sequence_split():
        if prefix is not None:
            if split and current_tp().index:
                prefix = torch.zeros_like(prefix)
            x = torch.cat([prefix, x], dim=1)
        return seq_scatter(x, split)
    x = tp_reduce(x) if split else x
    return x if prefix is None else torch.cat([prefix, x], dim=1)


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


class _GradBarrier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def bf16_grad_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity whose cotangent is cast to ``x``'s dtype: keeps the backward
    residual stream in bf16 where the fp32 logits would push fp32
    cotangents through every layer (the reference's custom VJP)."""
    return _GradBarrier.apply(x)


class _ChunkedXent(torch.autograd.Function):
    """Summed cross-entropy of ``x @ w.T`` against ``labels``, one chunk of
    the sequence at a time; the backward recomputes each chunk's logits
    (the reference's ``jax.checkpoint`` on the scan body), so no (B, S, V)
    buffer is ever held.

    Vocab-parallel where ``tp`` is given: ``w`` is this rank's block of rows
    from ``lo``. Each chunk's log-sum-exp and label logit are then this
    rank's (0 where another rank owns the label); after the chunks one MAX
    and one SUM all-reduce over the axis make them global (the log-sum-exp
    of the ranks' log-sum-exps). The backward's softmax takes the saved
    global log-sum-exp, ``dw`` is the rank's own rows and the partial ``dx``
    is all-reduced once, after the chunks, unless ``reduce_dx`` is False:
    under sequence parallelism ``x`` was gathered from the ranks' blocks,
    whose backward reduce-scatters ``dx`` instead."""

    @staticmethod
    def forward(ctx, x, w, labels, chunk: int, tp, reduce_dx: bool):
        lo = tp.index * w.shape[0] if tp is not None else 0
        lses, labs = [], []
        for start in range(0, x.shape[1], chunk):
            logits = unembed(w, x[:, start:start + chunk])
            lses.append(torch.logsumexp(logits, dim=-1))
            labs.append(_label_logits(logits, labels[:, start:start + chunk] - lo))
        lse, lab = torch.cat(lses, dim=1), torch.cat(labs, dim=1)
        if tp is not None:
            top = tp.all_reduce(lse, dist.ReduceOp.MAX)
            sums = tp.all_reduce(torch.stack([torch.exp(lse - top), lab]))
            lse, lab = top + torch.log(sums[0]), sums[1]
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for start in range(0, x.shape[1], chunk):
            total = total + (lse[:, start:start + chunk] - lab[:, start:start + chunk]).sum()
        ctx.save_for_backward(x, w, labels, lse)
        ctx.chunk, ctx.tp, ctx.lo, ctx.reduce_dx = chunk, tp, lo, reduce_dx
        return total

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        chunk, lo = ctx.chunk, ctx.lo
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for start in range(0, x.shape[1], chunk):
            x_k = x[:, start:start + chunk]
            # d(sum of lse - label logit)/d logits = softmax - one-hot
            logits = unembed(w, x_k)
            probs = logits.sub_(lse[:, start:start + chunk, None]).exp_()
            local = labels[:, start:start + chunk] - lo
            own = (local >= 0) & (local < w.shape[0])
            probs.scatter_add_(-1, local.clamp(0, w.shape[0] - 1)[..., None],
                               torch.where(own, -1.0, 0.0)[..., None])
            # bf16 operands with fp32 accumulation where w is bf16, as the
            # forward's product
            d_logits = (probs * g).reshape(-1, w.shape[0]).to(w.dtype)
            dx[:, start:start + chunk] = (d_logits @ w).reshape(x_k.shape)
            dw += _mm_fp32(d_logits.t(), x_k.reshape(-1, x.shape[-1]).to(w.dtype))
        if ctx.tp is not None and ctx.reduce_dx:
            dx = ctx.tp.all_reduce(dx)
        return dx, dw.to(w.dtype), None, None, None, None


def _label_logits(logits: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """The logit at each label's column ``local`` of ``logits``, or 0 where
    that column is another rank's (outside [0, V_local))."""
    own = (local >= 0) & (local < logits.shape[-1])
    got = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    return torch.where(own, got, 0.0)


def _mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation and output: one ``mm`` with
    ``out_dtype`` on CUDA, upcast operands on the CPU (as ``unembed``)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def chunked_xent(w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor, *,
                 chunk: int = 512, vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of the head ``w`` (V, D) over the
    final hidden states ``x`` (B, S, D) against ``labels`` (B, S), computed
    ``chunk`` positions at a time (the last chunk may be short) and never
    holding the (B, S, V) logits: the live logits are (B, chunk, V), in the
    forward and again in the backward, which recomputes them. Where ``w``
    has fewer rows than ``vocab`` it is this rank's block of a
    vocab-parallel head (under ``modes.tensor_parallel``), and the live
    logits are (B, chunk, V / tp). Under sequence parallelism ``x`` holds
    every position, gathered by the caller (``modes.seq_gather``), whose
    backward sums ``dx`` over the ranks. Under analysis mode the logits are
    held whole instead (``_dense_xent``). Port of the reference's
    ``chunked_xent``."""
    b, s, _ = x.shape
    x = bf16_grad_barrier(x)
    tp = None if vocab is None or w.shape[0] == vocab else current_tp()
    if analysis_form(x):
        return _dense_xent(w, x, labels, tp, not sequence_split()) / (b * s)
    total = _ChunkedXent.apply(x, w, labels, min(chunk, s), tp, not sequence_split())
    return total / (b * s)


def _dense_xent(w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor, tp,
                reduce_dx: bool) -> torch.Tensor:
    """The summed cross-entropy with the (B, S, V) logits held at once and
    differentiated by autograd: analysis mode's cost-exact form (the
    reference's unchunked branch), which recomputes nothing. Vocab-parallel
    where ``tp`` is given, with ``_ChunkedXent``'s collectives: x enters
    through f where ``reduce_dx`` (its gradient summed over "model"), the
    log-sum-exps' MAX and the SUM of their exponentials with the label
    logits (g, whose gradient each rank takes whole: every rank computes
    the same loss from the sums)."""
    lo = tp.index * w.shape[0] if tp is not None else 0
    if tp is not None and reduce_dx:
        x = tp_copy(x)
    logits = unembed(w, x)
    lse = torch.logsumexp(logits, dim=-1)
    lab = _label_logits(logits, labels - lo)
    if tp is not None:
        top = tp.all_reduce(lse.detach(), dist.ReduceOp.MAX)
        sums = tp_reduce(torch.stack([torch.exp(lse - top), lab]))
        lse, lab = top + torch.log(sums[0]), sums[1]
    return (lse - lab).sum()
