"""Prefill attention forward: the wrapper of the CUDA kernels that port the
Pallas kernel ``repro/kernels/flash_attention.py``. bf16 goes to the
tensor-core kernel in ``csrc/flash_attention_wgmma.cu`` (route ``wgmma``),
fp32 to the CUDA-core kernel in ``csrc/flash_attention.cu`` (route
``fp32``).

Both kernels read q (B, Sq, H, hd) and k, v (B, Skv, K, hd) through their
strides, map q head h to kv head h // (H/K) without repeating kv heads, and
mask ragged lengths. They take the head_dims in ``HEAD_DIMS``; 80
(gpt2-2.7b's) and 112 (the hybrid's) run the 128 instantiation with the
columns from 80 or 112 on read as zero and never stored, and 256
(gemma-2b's) has its own. ``FlashAttention`` puts the kernel under autograd for
training: its backward recomputes through the plain
``blockwise_attention`` on head-repeated k and v, as the reference's
custom VJP (``_bwd``, repro/kernels/flash_attention.py:108) does; the TPU
code has no backward kernel to port. (The SSD has its own autograd
function, ``kernels.ssd.SSD``; decode attention serves only.)
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256)   # 80, 112 on the 128 tiles, zero-padded
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.bfloat16: ("wgmma", "repro_flash_attention_wgmma"),
          torch.float32: ("fp32", "repro_flash_attention_fp32")}
WGMMA_BQ = 128      # q rows per block of the wgmma kernel
MAX_GRID_Y = 65535


def check_operands(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a 4-d CUDA tensor on the first one's
    device and of its dtype (float32 or bfloat16), with head_dim (the last
    axis) contiguous and every stride and the data pointer 16-byte aligned:
    the kernels load 16 bytes at a time along head_dim."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        where = f"{kernel} kernel: {name}"
        if not t.is_cuda:
            raise ValueError(f"{where} is on {t.device}, not CUDA")
        if t.device != first.device:
            raise ValueError(f"{where} is on {t.device}, not {first.device}")
        if t.dim() != 4:
            raise ValueError(f"{where} must be 4-d, got {tuple(t.shape)}")
        if t.dtype not in DTYPES or t.dtype != first.dtype:
            raise ValueError(f"{where} dtype {t.dtype}; need all float32 or all bfloat16")
        per16 = 16 // t.element_size()
        if t.stride(-1) != 1 or any(s % per16 for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{where}: strides {t.stride()} must be 1 on head_dim "
                             f"and 16-byte aligned elsewhere, as the data pointer")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) with K dividing H, on CUDA.
    Returns (B, Sq, H, hd) in q's dtype. Position i of q attends to kv
    positions <= i when ``causal`` (no offset), as blockwise_attention.
    bf16 runs on the tensor cores, fp32 on the CUDA cores; there is no
    fallback from one to the other."""
    check_operands("flash_attention", q=q, k=k, v=v)
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    route, entry = ROUTES[q.dtype]
    # grid: (ceil(Sq/64), B*H) for fp32, (B*H, ceil(Sq/128)) for wgmma
    grid_ok = (b * h <= MAX_GRID_Y if route == "fp32"
               else b * h < 2**31 and -(-sq // WGMMA_BQ) <= MAX_GRID_Y)
    if h % kh or hd not in HEAD_DIMS or min(b, sq, skv) < 1 or not grid_ok:
        raise ValueError(f"flash_attention kernel ({route}): unsupported H={h}, K={kh}, "
                         f"hd={hd}, B={b}, Sq={sq}, Skv={skv}")
    o = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, sq, skv, h, kh, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.routes[route] += 1
    return o


flash_attention.launches = 0
flash_attention.routes = {"wgmma": 0, "fp32": 0}


class FlashAttention(torch.autograd.Function):
    """Prefill attention with a gradient: the forward is the kernel (its
    plain version for CPU tensors) and saves q, k and v; the backward
    recomputes the attention with the plain ``blockwise_attention`` over
    head-repeated k and v and differentiates that. Only the
    forward launches a kernel, so ``flash_attention.launches`` counts
    forward launches."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        if q.device.type == "cpu":
            from repro_torch.kernels.ops import flash_attention_plain
            return flash_attention_plain(q, k, v, causal=causal)
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        from repro_torch.models.attention import blockwise_attention, repeat_kv
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            h = q.shape[2]
            out = blockwise_attention(q, repeat_kv(k, h), repeat_kv(v, h),
                                      causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None
