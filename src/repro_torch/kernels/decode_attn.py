"""GQA decode attention: the wrapper of the CUDA kernel in
``csrc/decode_attn.cu`` (port of the Pallas kernel
``repro/kernels/decode_attn.py``).

One query token per sequence against a (B, T, K, hd) cache; only the first
``cur_len`` positions are read. The kernel splits those positions over
``n_split`` blocks per (batch, kv head), planned here by ``plan_splits``,
and merges the partial softmax states in a second grid of the same call.
``cur_len`` is a host int, so no step waits on the device to learn it.

The block form (``partial=True``) is what a rank holding one block of the
cache's positions returns for the merge across ranks
(``models.attention.merge_partials``): o in fp32, normalised over the block
alone, and the log-sum-exp of its scores, (B, H) fp32.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, check_operands

HEAD_DIMS = (16, 32, 64, 112, 128, 256)   # the kernel's lane mappings; 112 on hd 128's
GROUPS = (1, 2, 4, 8)   # q heads per kv head the kernel is built for
BLOCKS_PER_SM = 2       # what the split planner aims at
MAX_GRID_YZ = 65535


def rows_per_step(hd: int, itemsize: int, group: int) -> int:
    """Cache positions one block reads per step of its loop: 8 warps, each
    lane group of hd*itemsize/16 lanes (at most the warp's 32: an fp32 row
    of hd 256 is two loads a lane) one row, U rows in flight per lane
    (``DecodeShape::STEP`` in ``csrc/decode_attn.cu``). hd 112 runs with
    the lane mapping of hd 128 (its last lanes' loads masked), so it reads
    the rows per step of hd 128."""
    lanes_per_row = min(32, (128 if hd == 112 else hd) * itemsize // 16)
    in_flight = 4 if group <= 4 else 2
    return 8 * (32 // lanes_per_row) * in_flight


def plan_splits(cur_len: int, batch: int, kv_heads: int, sm_count: int,
                step: int = rows_per_step(128, 2, 2)) -> tuple:
    """(n_split, rows_per_split): split the first ``cur_len`` positions of
    each (batch, kv head) over blocks so that the grid holds about
    ``BLOCKS_PER_SM`` blocks per SM. ``rows_per_split`` is a multiple of
    ``step`` (the rows one block step reads; the default is the serve
    shape's, bf16 hd 128 with 2 q heads per kv head); no split is empty."""
    if cur_len < 1 or min(batch, kv_heads, sm_count, step) < 1:
        raise ValueError(f"plan_splits: cur_len={cur_len}, batch={batch}, "
                         f"kv_heads={kv_heads}, sm_count={sm_count}, step={step}")
    steps = -(-cur_len // step)
    want = -(-BLOCKS_PER_SM * sm_count // (batch * kv_heads))
    n_split = max(1, min(want, steps, MAX_GRID_YZ))
    rows = -(-steps // n_split) * step
    return -(-cur_len // rows), rows


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len: int, *, partial: bool = False):
    """q: (B, 1, H, hd); caches: (B, T, K, hd), on CUDA; 1 <= cur_len <= T.
    Returns (B, 1, H, hd) in q's dtype, computed in fp32; with ``partial``
    the block form, (o (B, 1, H, hd) fp32, lse (B, H) fp32)."""
    check_operands("decode_attention", q=q, k_cache=k_cache, v_cache=v_cache)
    b, one, h, hd = q.shape
    t_len, kh = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != hd:
        raise ValueError(f"decode_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if h % kh or h // kh not in GROUPS or hd not in HEAD_DIMS or b > MAX_GRID_YZ:
        raise ValueError(f"decode_attention kernel: unsupported H={h}, K={kh}, "
                         f"hd={hd}, B={b}")
    cur_len = int(cur_len)
    if not 1 <= cur_len <= t_len:
        raise ValueError(f"decode_attention kernel: cur_len {cur_len} outside [1, {t_len}]")
    g = h // kh
    n_split, rows = plan_splits(cur_len, b, kh, sm_count(q.device.index),
                                rows_per_step(hd, q.element_size(), g))
    o = torch.empty((b, 1, h, hd), dtype=torch.float32 if partial else q.dtype,
                    device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) if partial else None
    part = (torch.empty(b * kh * n_split * g * (hd + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else o)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), part.data_ptr(), DTYPES[q.dtype],
            b, h, kh, hd, cur_len, n_split, rows,
            q.stride(0), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    decode_attention.last_split = (n_split, rows)
    return (o, lse) if partial else o


decode_attention.launches = 0
decode_attention.last_split = None    # (n_split, rows_per_split) of the last launch
