"""GQA decode attention: the wrapper of the CUDA kernel in
``csrc/decode_attn.cu`` (port of the Pallas kernel
``repro/kernels/decode_attn.py``).

One query token per sequence against a (B, T, K, hd) cache; only the first
``cur_len`` positions are read. ``cur_len`` is a host int, so no step waits
on the device to learn it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, check_operands

GROUPS = (1, 2, 4, 8)   # q heads per kv head the kernel is built for


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len: int) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, T, K, hd), on CUDA; 1 <= cur_len <= T.
    Returns (B, 1, H, hd) in q's dtype, computed in fp32."""
    check_operands("decode_attention", q=q, k_cache=k_cache, v_cache=v_cache)
    b, one, h, hd = q.shape
    t_len, kh = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != hd:
        raise ValueError(f"decode_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if h % kh or h // kh not in GROUPS or hd not in HEAD_DIMS or b > 65535:
        raise ValueError(f"decode_attention kernel: unsupported H={h}, K={kh}, "
                         f"hd={hd}, B={b}")
    cur_len = int(cur_len)
    if not 1 <= cur_len <= t_len:
        raise ValueError(f"decode_attention kernel: cur_len {cur_len} outside [1, {t_len}]")
    o = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
            DTYPES[q.dtype], b, h, kh, hd, cur_len,
            q.stride(0), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
