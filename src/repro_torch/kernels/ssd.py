"""Mamba2 SSD: the wrappers of the CUDA kernels that port the Pallas kernel
``repro/kernels/ssd.py`` and the plain combine around it.

``ssd`` (the full SSD, what ``ops.ssd`` calls on the card) dispatches by
dtype. bf16 goes to the tensor-core kernel in ``csrc/ssd_wgmma.cu`` (route
``wgmma``), which computes the whole SSD in one launch: intra-chunk term,
inter-chunk term and state, y written once in bf16. fp32 goes to
``ssd_intra_chunk`` (route ``fp32``), the CUDA-core kernel in
``csrc/ssd.cu`` (per chunk and head the causal intra-chunk output, the
chunk's end state and the chunk decay; a ragged last chunk is masked, not
padded), and the inter-chunk part in plain PyTorch, as the reference's
``ssd()`` does in plain JAX: a scan over the chunk states and ``y_inter =
C . S_prev * exp(cs)``. There is no fallback from one route to the other.

``SSD`` puts the full SSD under autograd for training: the forward is
``ssd`` on CUDA tensors and the plain ``ssd_chunked`` on CPU tensors; the
backward recomputes through the plain ``ssd_chunked`` and differentiates
it, as the reference's training does (it gives the Pallas SSD no VJP, and
trains through ``ssd_chunked``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

HEAD_DIMS = (16, 32, 64, 128)   # P the kernels are built for
MAX_CHUNK = 256                 # of the fp32 kernel
# the tensor-core kernel keeps the state (N padded to 64-row tiles, by P)
# in registers: N up to 128, and up to 64 at P = 128
MAX_STATE_WGMMA = 128
MAX_STATE_ELEMS_WGMMA = 8192


def check_operands(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int) -> None:
    """Raise unless the operands are what the kernel takes: contiguous CUDA
    tensors on one device, 16-byte aligned; x (B, S, H, P) and b/c (B, S, N)
    all float32 or all bfloat16; dt (B, S, H) and a (H,) float32;
    P in ``HEAD_DIMS``, N a multiple of 8, 1 <= chunk."""
    where = "ssd kernel"
    tensors = {"x": x, "dt": dt, "a": a, "b_mat": b_mat, "c_mat": c_mat}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{where}: {name} is on {t.device}; all must be on "
                             f"one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{where}: {name} must be contiguous and 16-byte aligned")
    if x.dim() != 4 or b_mat.dim() != 3:
        raise ValueError(f"{where}: x {tuple(x.shape)} must be (B, S, H, P), "
                         f"b_mat {tuple(b_mat.shape)} (B, S, N)")
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or tuple(b_mat.shape) != (bsz, s, n) or c_mat.shape != b_mat.shape):
        raise ValueError(f"{where}: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b_mat.shape)}, c {tuple(c_mat.shape)}")
    if x.dtype not in DTYPES or b_mat.dtype != x.dtype or c_mat.dtype != x.dtype:
        raise ValueError(f"{where}: x, b_mat, c_mat dtypes {x.dtype}, {b_mat.dtype}, "
                         f"{c_mat.dtype}; need all float32 or all bfloat16")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"{where}: dt and a must be float32, got {dt.dtype}, {a.dtype}")
    if p not in HEAD_DIMS or n % 8 or n < 8 or chunk < 1 or min(bsz, s, h) < 1:
        raise ValueError(f"{where}: unsupported P={p}, N={n}, chunk={chunk}, "
                         f"B={bsz}, S={s}, H={h}")


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); dt: (B, S, H) post-softplus; a: (H,) negative;
    b/c: (B, S, N), fp32 on CUDA. Chunks of min(chunk, S) positions, the
    last one ragged when S does not divide. Returns fp32 (y_intra (B, S, H,
    P), chunk_states (B, NC, H, N, P), chunk_decay (B, NC, H))."""
    check_operands(x, dt, a, b_mat, c_mat, chunk)
    if x.dtype != torch.float32:
        raise ValueError(f"ssd kernel (fp32): x is {x.dtype}; bf16 takes the wgmma route "
                         f"of ssd()")
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    lc = min(chunk, s)
    if lc > MAX_CHUNK:
        raise ValueError(f"ssd kernel: chunk {lc} > {MAX_CHUNK}")
    nc = -(-s // lc)
    if bsz * nc > 2**31 - 1 or h > 65535 or -(-n // 64) > 65535:
        raise ValueError(f"ssd kernel: grid too large for B={bsz}, NC={nc}, H={h}, N={n}")
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    states = torch.empty((bsz, nc, h, n, p), dtype=torch.float32, device=x.device)
    decay = torch.empty((bsz, nc, h), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.repro_ssd_chunk(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            y.data_ptr(), states.data_ptr(), decay.data_ptr(), bsz, s, h, p, n, lc,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd")
    ssd_intra_chunk.launches += 1
    return y, states, decay


ssd_intra_chunk.launches = 0


def _ssd_wgmma(x, dt, a, b_mat, c_mat, chunk, initial_state):
    """The bf16 route: one launch of the tensor-core kernel."""
    check_operands(x, dt, a, b_mat, c_mat, chunk)
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    n_pad = -(-n // 64) * 64
    if n > MAX_STATE_WGMMA or n_pad * p > MAX_STATE_ELEMS_WGMMA or bsz * -(-h // 2) >= 2**31:
        raise ValueError(f"ssd kernel (wgmma): unsupported N={n} at P={p} (the state, N "
                         f"padded to {n_pad} by P, must hold <= {MAX_STATE_ELEMS_WGMMA} "
                         f"values), B={bsz}, H={h}")
    if initial_state is not None:
        if (tuple(initial_state.shape) != (bsz, h, n, p)
                or initial_state.dtype != torch.float32 or initial_state.device != x.device
                or not initial_state.is_contiguous() or initial_state.data_ptr() % 16):
            raise ValueError(f"ssd kernel (wgmma): initial_state must be a contiguous fp32 "
                             f"(B, H, N, P) = {(bsz, h, n, p)} tensor on {x.device}")
    y = torch.empty((bsz, s, h, p), dtype=torch.bfloat16, device=x.device)
    final = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.repro_ssd_wgmma(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), final.data_ptr(), bsz, s, h, p, n,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd (wgmma)")
    return y, final


def _ssd_fp32(x, dt, a, b_mat, c_mat, chunk, initial_state):
    """The fp32 route: the intra-chunk kernel (which checks the operands)
    plus the inter-chunk combine in plain PyTorch."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    y_intra, chunk_states, chunk_decay = ssd_intra_chunk(x, dt, a, b_mat, c_mat,
                                                         chunk=chunk)
    lc = min(chunk, s)
    nc = chunk_states.shape[1]
    pad = nc * lc - s
    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state)
    prev = []                                   # state entering each chunk
    for ci in range(nc):
        prev.append(state)
        state = chunk_decay[:, ci, :, None, None] * state + chunk_states[:, ci]
    prev = torch.stack(prev, dim=1)             # (B, NC, H, N, P)
    # y_inter = C_i . S_prev * exp(cs_i), cs recomputed in fp32 (zero-padded)
    da = F.pad(dt.float() * a.float(), (0, 0, 0, pad)).reshape(bsz, nc, lc, h)
    cs = torch.cumsum(da, dim=2)
    cm = F.pad(c_mat.float(), (0, 0, 0, pad)).reshape(bsz, nc, lc, n)
    y_inter = torch.einsum("bcin,bchnp->bcihp", cm, prev) * torch.exp(cs)[..., None]
    y = y_intra + y_inter.reshape(bsz, nc * lc, h, p)[:, :s]
    return y.to(x.dtype), state


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
        c_mat: torch.Tensor, *, chunk: int, initial_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full SSD on CUDA tensors, the same result as
    ``models.mamba2.ssd_chunked``: (y (B, S, H, P) in x's dtype, final_state
    (B, H, N, P) fp32). bf16 runs on the tensor cores in one launch (which
    walks 64-row tiles whatever ``chunk``: the function does not depend on
    it); fp32 on the CUDA-core kernel plus the plain combine. Counts every
    call in ``ssd.launches`` and by route in ``ssd.routes``."""
    if x.dtype == torch.bfloat16:
        route, out = "wgmma", _ssd_wgmma(x, dt, a, b_mat, c_mat, chunk, initial_state)
    else:
        route, out = "fp32", _ssd_fp32(x, dt, a, b_mat, c_mat, chunk, initial_state)
    ssd.launches += 1
    ssd.routes[route] += 1
    return out


ssd.launches = 0
ssd.routes = {"wgmma": 0, "fp32": 0}


class SSD(torch.autograd.Function):
    """The full SSD with a gradient: ``SSD.apply(x, dt, a, b_mat, c_mat,
    chunk, initial_state)`` returns (y, final_state) as ``ssd``. The
    forward is the kernel (``ssd``) for CUDA tensors and the plain
    ``ssd_chunked`` for CPU tensors, and saves its inputs; the backward
    recomputes ``ssd_chunked`` from them and differentiates it, giving
    gradients for x, dt, a, b_mat, c_mat and ``initial_state``. Either
    output's gradient may be None (unused). Only the forward launches a
    kernel, so ``ssd.launches`` and ``ssd.routes`` count forward calls."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, chunk: int, initial_state):
        ctx.save_for_backward(x, dt, a, b_mat, c_mat, initial_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            from repro_torch.kernels.ref import ssd_ref
            return ssd_ref(x, dt, a, b_mat, c_mat, chunk=chunk, initial_state=initial_state)
        return ssd(x, dt, a, b_mat, c_mat, chunk=chunk, initial_state=initial_state)

    @staticmethod
    def backward(ctx, grad_y, grad_final):
        from repro_torch.models.mamba2 import ssd_chunked
        needs = ctx.needs_input_grad[:5] + ctx.needs_input_grad[6:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            outs = ssd_chunked(*leaves[:5], chunk=ctx.chunk, initial_state=leaves[5])
            pairs = [(o, g) for o, g in zip(outs, (grad_y, grad_final)) if g is not None]
            wrt = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                             [g for _, g in pairs], allow_unused=True))
        out = [next(grads) if t is not None and t.requires_grad else None for t in leaves]
        return (*out[:5], None, out[5])
