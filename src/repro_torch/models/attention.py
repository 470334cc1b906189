"""Attention (port of ``repro.models.attention``): the plain blockwise and
dense forms, the plain KV-cache decode, and the self-attention sub-block.

Layouts are the reference's: activations (B, S, H, hd), caches (B, T, K, hd)
with K kv heads. The sub-block reaches the CUDA kernels through
``kernels.ops`` at the two call sites where the reference calls
``blockwise_attention`` (prefill) and ``decode_attention`` (decode); on CPU
tensors ``ops`` runs exactly those plain functions.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, head_rms_norm

_NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, H, hd): kv head j serves q heads
    j*H/K .. (j+1)*H/K - 1, as ``jnp.repeat``."""
    k = x.shape[2]
    if k == num_heads:
        return x
    return torch.repeat_interleave(x, num_heads // k, dim=2)


def dense_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """Masked attention that materializes the scores: the kernel oracle."""
    sq, hd = q.shape[1], q.shape[3]
    skv = k.shape[1]
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        q_pos = torch.arange(sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(skv, device=q.device)[None, :]
        s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, kv_block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over kv blocks with fp32 accumulators.
    q: (B, Sq, H, hd); k, v: (B, Skv, H, hd) (already repeated). The kv
    length is padded to whole blocks and the padding masked."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    kv_block = min(kv_block, skv)
    n_blocks = (skv + kv_block - 1) // kv_block
    pad = n_blocks * kv_block - skv
    if pad:
        k = nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / np.sqrt(hd)
    qf = (q.float() * scale).transpose(1, 2)                  # (B, H, Sq, hd)
    kb = k.transpose(1, 2).reshape(b, h, n_blocks, kv_block, hd)
    vb = v.transpose(1, 2).reshape(b, h, n_blocks, kv_block, hd)
    q_pos = torch.arange(sq, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for blk in range(n_blocks):
        kv_pos = blk * kv_block + torch.arange(kv_block, device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb[:, :, blk].float())
        mask = kv_pos[None, :] < skv
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        s = torch.where(mask[None, None], s, _NEG_INF)
        new_max = torch.maximum(row_max, s.amax(dim=-1))
        corr = torch.exp(row_max - new_max)
        p = torch.exp(s - new_max[..., None])
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   vb[:, :, blk].float())
        row_sum = row_sum * corr + p.sum(dim=-1)
        row_max = new_max
    out = acc / row_sum[..., None].clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len: int, num_heads: int) -> torch.Tensor:
    """One query token against the first ``cur_len`` cache positions, with
    the reference's mixed precision: q scaled in fp32 then cast to the cache
    dtype, fp32 scores, probabilities cast to the cache dtype before P.V,
    fp32 accumulation. q: (B, 1, H, hd); caches (B, T, K, hd)."""
    t, hd = k_cache.shape[1], k_cache.shape[3]
    k = repeat_kv(k_cache, num_heads)
    v = repeat_kv(v_cache, num_heads)
    scale = 1.0 / np.sqrt(hd)
    q = (q.float() * scale).to(k.dtype)
    # products of bf16 values are exact in fp32: fp32 accumulation as the
    # reference's preferred_element_type
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float())
    mask = torch.arange(t, device=q.device)[None, None, None, :] < cur_len
    s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqt,bthd->bqhd", p.to(k.dtype).float(), v.float())
    return out.to(k_cache.dtype)


# --------------------------------------------------------------------------- #
# Full attention sub-block (projections + rope + attention + out-proj)
# --------------------------------------------------------------------------- #
def attn_init(cfg, dtype, device) -> nn.ParameterDict:
    """Uninitialised attention parameters in the reference's layout
    (``x @ w``); ``init_attn`` fills them."""
    hd = cfg.resolved_head_dim
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.d_model

    def empty(*shape):
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                            requires_grad=False)

    p = nn.ParameterDict({"wq": empty(d, h * hd), "wk": empty(d, kh * hd),
                          "wv": empty(d, kh * hd), "wo": empty(h * hd, d)})
    if cfg.use_qk_norm:
        p["q_norm"] = empty(hd)
        p["k_norm"] = empty(hd)
    return p


@torch.no_grad()
def init_attn(p: nn.ParameterDict, cfg, generator: torch.Generator) -> None:
    """Same distributions as the reference's ``attn_init`` (not the same
    numbers: the generators differ)."""
    hd = cfg.resolved_head_dim
    sc, so = 1.0 / np.sqrt(cfg.d_model), 1.0 / np.sqrt(cfg.num_heads * hd)
    for name, scale in (("wq", sc), ("wk", sc), ("wv", sc), ("wo", so)):
        w = p[name]
        w.copy_(torch.randn(w.shape, generator=generator, device=generator.device) * scale)
    if cfg.use_qk_norm:
        p["q_norm"].zero_()
        p["k_norm"].zero_()


def _project_qkv(p: Mapping, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                 rope: bool = True):
    """q, k, v of the heads whose columns ``wq``, ``wk`` and ``wv`` hold:
    all of them, or this rank's under tensor parallelism (the local head
    counts come from the widths, so the GQA group stays the config's)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, p["wq"].shape[-1] // hd, hd)
    k = (x @ p["wk"]).reshape(b, s, p["wk"].shape[-1] // hd, hd)
    v = (x @ p["wv"]).reshape(b, s, p["wv"].shape[-1] // hd, hd)
    if cfg.use_qk_norm:            # qk-norm before RoPE
        q = head_rms_norm(q, p["q_norm"])
        k = head_rms_norm(k, p["k_norm"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(p: Mapping, cfg, x: torch.Tensor, *, causal: bool = True,
                   rope: bool = True) -> torch.Tensor:
    """The training and ``forward`` call site: differentiable on both
    routes (``ops.flash_attention``), on the heads that ``p`` holds."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions, rope=rope)
    out = ops.flash_attention(q, k, v, causal=causal)
    return out.reshape(b, s, -1) @ p["wo"]


def self_attention_prefill(p: Mapping, cfg, x: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """Causal attention over the prompt; writes its k/v into positions
    [0, S) of this layer's caches (B, T, K, hd) in place, where the
    reference returns them padded to T."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=True)
    k_cache[:, :s] = k
    v_cache[:, :s] = v
    return out.reshape(b, s, -1) @ p["wo"]


def self_attention_decode(p: Mapping, cfg, x: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, index: int) -> torch.Tensor:
    """One-token decode. x: (B, 1, D); caches (B, T, K, hd), updated in place
    at ``index`` (a host int). Attends to positions [0, index]."""
    b = x.shape[0]
    if not 0 <= index < k_cache.shape[1]:
        # the reference's dynamic_update_slice would clamp silently
        raise IndexError(f"cache index {index} outside a cache of {k_cache.shape[1]}")
    positions = torch.full((1,), index, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    k_cache[:, index] = k[:, 0]
    v_cache[:, index] = v[:, 0]
    out = ops.decode_attention(q, k_cache, v_cache, index + 1)
    return out.reshape(b, 1, -1) @ p["wo"]
