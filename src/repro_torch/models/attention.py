"""Attention (port of ``repro.models.attention``): the plain blockwise and
dense forms, the plain KV-cache decode, the self-attention sub-block and the
enc-dec's cross-attention.

Layouts are the reference's: activations (B, S, H, hd), caches (B, T, K, hd)
with K kv heads. The sub-blocks reach the CUDA kernels through
``kernels.ops`` at the call sites where the reference calls
``blockwise_attention`` (training, prefill, cross-attention) and
``decode_attention`` (decode); on CPU tensors ``ops`` runs exactly those
plain functions.

On a mesh the serve steps split each cache by sequence
(``parallel.sharding.cache_pspecs``, ``models.modes.split_cache``): a rank
holds positions [r·T/n, (r+1)·T/n) of every kv head, as the reference's
flash-decode layout keeps the scores sequence-sharded rather than
replicating the cache. Prefill writes the rank's block of the prompt's k
and v (every kv head: gathered over "model" where the rank computed its
own). Decode writes the new token's k and v on the rank whose block holds
``index``, gathers the q heads over "model", runs the decode kernel on the
block for every head (``decode_attention_partial``: o and its log-sum-exp,
in fp32), gathers those over the cache's axes and merges them
(``merge_partials``); each rank then keeps its own q heads' rows for the
row-parallel ``wo``. The reference leaves that merge to XLA's partitioned
softmax; no Pallas kernel computes it. An enc-dec's cross cache is split
by its own axes (``split_cache``'s ``cross``): the prefill writes the
rank's block of the encoder positions (every kv head, gathered over
"model"), and a decode step attends to it by the same steps, every position
of the block valid.
"""
from __future__ import annotations

from typing import Callable, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, head_rms_norm
from repro_torch.models.modes import current_split_cache, current_tp

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


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             cur_len: int, num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``decode_attention`` on one block of a cache's positions, in the form
    that ``merge_partials`` joins: (o (B, 1, H, hd) fp32, normalised over
    the block's first ``cur_len`` >= 1 positions alone; lse (B, H) fp32, the
    log of the block's softmax denominator), with ``decode_attention``'s
    mixed precision (the probabilities cast to the cache dtype before P.V,
    the sum kept in fp32)."""
    t, hd = k_cache.shape[1], k_cache.shape[3]
    k = repeat_kv(k_cache, num_heads)
    v = repeat_kv(v_cache, num_heads)
    q = (q.float() * (1.0 / np.sqrt(hd))).to(k.dtype)
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float())
    mask = torch.arange(t, device=q.device)[None, None, None, :] < cur_len
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqt,bthd->bqhd", (e / denom).to(k.dtype).float(), v.float())
    return out, (m + torch.log(denom))[:, :, 0, 0]


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The attention over a whole cache from its blocks' partial states: o
    (n, ..., hd) fp32 and lse (n, ...) fp32 of n blocks (an empty block's o
    0 and lse -inf), weighted by exp(lse - max): fp32 (..., hd)."""
    w = torch.exp(lse - lse.amax(dim=0))
    return (o * (w / w.sum(dim=0))[..., None]).sum(dim=0)


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


def _kv_weights(p: Mapping, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The columns of ``wk`` and ``wv`` that the q heads of ``wq`` read.

    All of them where the q heads are whole or the kv heads are split with
    them (the local counts keep the config's group). Under tensor
    parallelism where the q heads are split and the kv heads do not divide
    the axis (``parallel.sharding`` leaves ``wk`` and ``wv`` replicated:
    gemma-2b's one kv head, or 2 on a "model" axis of 4), those of the kv
    heads of this rank's q heads, q head h reading kv head h // (H/K) as
    ``repeat_kv`` maps it: the one kv head they share where the axis is a
    multiple of the kv heads, else one kv head per q head. The unread
    columns get no gradient here; the step sums the replicated leaves'
    gradients over "model" (``partial`` leaves)."""
    hd = cfg.resolved_head_dim
    h = p["wq"].shape[-1] // hd
    if h == cfg.num_heads or p["wk"].shape[-1] // hd < cfg.num_kv_heads:
        return p["wk"], p["wv"]
    group = cfg.num_heads // cfg.num_kv_heads
    first = current_tp().index * h
    if group % h == 0:
        cols = slice(first // group * hd, (first // group + 1) * hd)
        return p["wk"][:, cols], p["wv"][:, cols]
    dev = p["wk"].device
    heads = torch.arange(first, first + h, device=dev) // group
    cols = (heads[:, None] * hd + torch.arange(hd, device=dev)).reshape(-1)
    return p["wk"].index_select(-1, cols), p["wv"].index_select(-1, cols)


def _project(x: torch.Tensor, w: torch.Tensor, hd: int, norm, cfg,
             positions: torch.Tensor, rope: bool) -> torch.Tensor:
    """The heads of ``x @ w``, qk-normed (``norm``, where the config has
    it) before RoPE."""
    b, s, _ = x.shape
    t = (x @ w).reshape(b, s, w.shape[-1] // hd, hd)
    if norm is not None and cfg.use_qk_norm:
        t = head_rms_norm(t, norm)
    return apply_rope(t, positions, cfg.rope_theta) if rope else t


def _project_kv(p: Mapping, cfg, x: torch.Tensor, positions: torch.Tensor,
                wk: torch.Tensor, wv: torch.Tensor, rope: bool = True):
    hd = cfg.resolved_head_dim
    return (_project(x, wk, hd, p.get("k_norm"), cfg, positions, rope),
            _project(x, wv, hd, None, cfg, positions, False))


def _project_qkv(p: Mapping, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                 rope: bool = True):
    """q, k, v of the heads whose columns ``wq``, ``wk`` and ``wv`` hold:
    all of them, or this rank's under tensor parallelism (the local head
    counts come from the widths, so the GQA group stays the config's; kv
    heads replicated beside split q heads as ``_kv_weights`` picks them)."""
    q = _project(x, p["wq"], cfg.resolved_head_dim, p.get("q_norm"), cfg, positions, rope)
    return (q,) + _project_kv(p, cfg, x, positions, *_kv_weights(p, cfg), rope=rope)


def self_attention(p: Mapping, cfg, x: torch.Tensor, *, causal: bool = True,
                   rope: bool = True) -> torch.Tensor:
    """The training and ``forward`` call site: differentiable on both
    routes (``ops.flash_attention``), on the heads that ``p`` holds."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions, rope=rope)
    out = ops.flash_attention(q, k, v, causal=causal)
    return out.reshape(b, s, -1) @ p["wo"]


def _cache_kv(p: Mapping, cfg, k: torch.Tensor, v: torch.Tensor,
              whole: Callable[[], Tuple[torch.Tensor, torch.Tensor]]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k and v of every kv head, as a cache holds them, from those this
    rank computed: as they are where they are all of them; gathered over
    "model" where ``wk`` and ``wv`` are this rank's blocks; ``whole()``
    (projected again from the whole leaves) where ``_kv_weights`` picked
    the kv heads of this rank's q heads."""
    kh = cfg.num_kv_heads
    if k.shape[2] == kh:
        return k, v
    if p["wk"].shape[-1] < kh * cfg.resolved_head_dim:
        kv = current_tp().all_gather(torch.stack([k, v]), 3)
        return kv[0], kv[1]
    return whole()


def _block_start(k_cache: torch.Tensor, cross: bool = False) -> Tuple[int, int]:
    """(first position of this rank's block of the self cache, or of the
    cross cache where ``cross``, positions in the whole cache): (0, T) for
    a whole cache."""
    split = current_split_cache(cross)
    block = k_cache.shape[1]
    if split is None:
        return 0, block
    return split.index * block, split.ranks * block


def _write_block(k_cache: torch.Tensor, v_cache: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, cross: bool = False) -> None:
    """Positions [0, S) of k and v (B, S, K, hd), every kv head, written into
    this rank's block of the caches (B, T, K, hd) in place."""
    first, _ = _block_start(k_cache, cross)
    n = min(max(k.shape[1] - first, 0), k_cache.shape[1])
    k_cache[:, :n] = k[:, first:first + n]
    v_cache[:, :n] = v[:, first:first + n]


def _decode_cached(cfg, q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                   length: int, cross: bool = False) -> torch.Tensor:
    """The attention of q (B, 1, h, hd), all q heads or this rank's h,
    over the first ``length`` positions of a cache that holds every kv head
    (the self cache, or the cross cache where ``cross``), whole or this
    rank's block of its split: (B, 1, h, hd) in the cache dtype. On a split
    cache the module docstring's steps: the q heads gathered over "model",
    the kernel's block form on the block (nothing launched on a block with
    no position below ``length``), the merge over the cache's axes, this
    rank's heads kept."""
    heads = q.shape[2]
    if heads != cfg.num_heads:                    # this rank's q heads of all
        q = current_tp().all_gather(q, 2)
    split = current_split_cache(cross)
    if split is None:
        out = ops.decode_attention(q, k_cache, v_cache, length)
    else:
        block = k_cache.shape[1]
        cur = min(max(length - split.index * block, 0), block)
        o, lse = ops.decode_attention_partial(q, k_cache, v_cache, cur)
        parts = split.all_gather(torch.cat([o[:, 0], lse[..., None]], -1)[None])
        out = merge_partials(parts[..., :-1], parts[..., -1])[:, None].to(k_cache.dtype)
    if heads != cfg.num_heads:
        i = current_tp().index
        out = out[:, :, i * heads:(i + 1) * heads]
    return out


def self_attention_prefill(p: Mapping, cfg, x: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """Causal attention over the prompt; writes its k/v into positions
    [0, S) of this layer's caches (B, T, K, hd) in place, where the
    reference returns them padded to T; on a split cache, the positions of
    this rank's block."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=True)
    _write_block(k_cache, v_cache, *_cache_kv(
        p, cfg, k, v, lambda: _project_kv(p, cfg, x, positions, p["wk"], p["wv"])))
    return out.reshape(b, s, -1) @ p["wo"]


def self_attention_decode(p: Mapping, cfg, x: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, index: int) -> torch.Tensor:
    """One-token decode. x: (B, 1, D); caches (B, T, K, hd), updated in place
    at ``index`` (a host int). Attends to positions [0, index]. On a split
    cache the module docstring's steps: the write where the block holds
    ``index``, the q heads gathered over "model", the kernel's block form
    on the block (nothing launched on a block with no position below
    ``index`` + 1) and the merge over the cache's axes."""
    b = x.shape[0]
    first, total = _block_start(k_cache)
    block = k_cache.shape[1]
    if not 0 <= index < total:
        # the reference's dynamic_update_slice would clamp silently
        raise IndexError(f"cache index {index} outside a cache of {total}")
    positions = torch.full((1,), index, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    k, v = _cache_kv(p, cfg, k, v,
                     lambda: _project_kv(p, cfg, x, positions, p["wk"], p["wv"]))
    if first <= index < first + block:
        k_cache[:, index - first] = k[:, 0]
        v_cache[:, index - first] = v[:, 0]
    out = _decode_cached(cfg, q, k_cache, v_cache, index + 1)
    return out.reshape(b, 1, -1) @ p["wo"]


# --------------------------------------------------------------------------- #
# Cross-attention (Whisper decoder)
# --------------------------------------------------------------------------- #
def cross_attn_init(cfg, dtype, device) -> nn.ParameterDict:
    """The leaves of ``attn_init`` (``wq``, ``wk``, ``wv``, ``wo``), which
    ``init_attn`` fills, as the reference's ``cross_attn_init``."""
    return attn_init(cfg, dtype, device)


def _cross_project(cfg, enc_out: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    return (enc_out @ wk).reshape(b, s, -1, hd), (enc_out @ wv).reshape(b, s, -1, hd)


def cross_kv(p: Mapping, cfg, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """k and v of the encoder's output (B, Senc, D): each (B, Senc, K, hd),
    no RoPE, no norm; under tensor parallelism those of the kv heads of
    this rank's q heads (``_kv_weights``)."""
    return _cross_project(cfg, enc_out, *_kv_weights(p, cfg))


def cross_attention(p: Mapping, cfg, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """x (B, S, D) attends to every encoder position of ``enc_kv`` ((k, v),
    each (B, Senc, K, hd), from ``cross_kv`` or the cache). The reference
    runs ``blockwise_attention(..., causal=False)``; the port runs its
    kernels there. S > 1 (training, prefill) goes to the flash kernel,
    non-causal, under ``FlashAttention``, so that the gradient reaches k
    and v and, through ``cross_kv``, the encoder. S = 1 outside autograd (a
    decode step) goes to the decode kernel with ``cur_len`` = Senc: the
    same function, one query against every frame, where the flash kernel
    would spend a 128-row q tile on one row. A one-row call that needs a
    gradient stays on flash. On CPU tensors both routes run their plain
    versions."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, -1, hd)
    k, v = enc_kv
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if s == 1 and not needs_grad:
        out = ops.decode_attention(q, k, v, k.shape[1])
    else:
        out = ops.flash_attention(q, k, v, causal=False)
    return out.reshape(b, s, -1) @ p["wo"]


def cross_prefill(p: Mapping, cfg, x: torch.Tensor, enc_out: torch.Tensor,
                  cross_k: torch.Tensor, cross_v: torch.Tensor) -> torch.Tensor:
    """``cross_attention`` of the prompt x (B, S, D) over ``cross_kv`` of
    the encoder's output, which it also writes into this layer's cross
    cache (B, Senc, K, hd) in place: every kv head (gathered over "model"
    where ``wk`` and ``wv`` are this rank's blocks), and on a split cross
    cache the positions of this rank's block."""
    k, v = cross_kv(p, cfg, enc_out)
    out = cross_attention(p, cfg, x, (k, v))
    _write_block(cross_k, cross_v, *_cache_kv(
        p, cfg, k, v, lambda: _cross_project(cfg, enc_out, p["wk"], p["wv"])), cross=True)
    return out


def cross_attention_decode(p: Mapping, cfg, x: torch.Tensor, cross_k: torch.Tensor,
                           cross_v: torch.Tensor) -> torch.Tensor:
    """One token x (B, 1, D) against every encoder position of the cross
    cache (B, Senc, K, hd), whole or this rank's block: the decode kernel
    with ``cur_len`` the cache's length (a block's every position), by the
    steps of ``self_attention_decode`` on a split cache."""
    b = x.shape[0]
    q = (x @ p["wq"]).reshape(b, 1, -1, cfg.resolved_head_dim)
    out = _decode_cached(cfg, q, cross_k, cross_v, _block_start(cross_k, cross=True)[1],
                         cross=True)
    return out.reshape(b, 1, -1) @ p["wo"]
