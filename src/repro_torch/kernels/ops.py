"""Dispatch for the kernels, the counterpart of ``repro.kernels.ops``.

A tensor on the CPU goes to the plain PyTorch version, the function the
kernel stands in for at its call site: ``flash_attention_plain`` here,
``ref.decode_attention_ref`` and ``ref.ssd_ref`` (``ssd_chunked``). A CUDA
tensor goes to the CUDA kernel, which raises on what it does not take:
there is no fallback from the card to a plain version. Prefill attention
runs under ``kernels.flash_attention.FlashAttention`` and the SSD under
``kernels.ssd.SSD``: each makes that choice and gives its kernel a gradient
(the backward recomputes through the plain version); decode attention has
none (serving only). Each kernel wrapper
counts its launches in ``<wrapper>.launches``
(``kernels.flash_attention.flash_attention``,
``kernels.decode_attn.decode_attention`` and ``kernels.ssd.ssd``, whatever
the route); the flash and SSD wrappers also count them by route in
``<wrapper>.routes`` (``wgmma`` for bf16, ``fp32``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attn as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels.ref import decode_attention_ref


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True) -> torch.Tensor:
    """blockwise_attention over head-repeated k/v: the reference's call
    sites (``self_attention`` and ``self_attention_prefill``)."""
    from repro_torch.models.attention import blockwise_attention, repeat_kv
    h = q.shape[2]
    return blockwise_attention(q, repeat_kv(k, h), repeat_kv(v, h), causal=causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd). Returns (B, Sq, H, hd).
    ``FlashAttention`` runs the kernel on CUDA and the plain version on
    the CPU; its backward recomputes through the plain version."""
    return _fa.FlashAttention.apply(q, k, v, causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len: int) -> torch.Tensor:
    """q: (B, 1, H, hd); caches (B, T, K, hd); cur_len a host int."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cur_len)
    return _dec.decode_attention(q, k_cache, v_cache, cur_len)


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cur_len: int):
    """The block form on a rank's block of a cache split by sequence: (o
    (B, 1, H, hd) fp32, lse (B, H) fp32) over its first ``cur_len``
    positions. A block with none (``cur_len`` 0) launches nothing: o is 0
    and lse -inf, which the merge weighs 0."""
    if cur_len == 0:
        b, _, h, hd = q.shape
        return (q.new_zeros((b, 1, h, hd), dtype=torch.float32),
                q.new_full((b, h), float("-inf"), dtype=torch.float32))
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cur_len, partial=True)
    return _dec.decode_attention(q, k_cache, v_cache, cur_len, partial=True)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
        c_mat: torch.Tensor, *, chunk: int, initial_state: Optional[torch.Tensor] = None):
    """x: (B, S, H, P); dt: (B, S, H); a: (H,); b/c: (B, S, N). Returns
    (y (B, S, H, P) in x's dtype, final_state (B, H, N, P) fp32). ``SSD``
    runs the kernel on CUDA and ``ssd_chunked`` on the CPU; its backward
    recomputes through ``ssd_chunked``."""
    return _ssd.SSD.apply(x, dt, a, b_mat, c_mat, chunk, initial_state)
