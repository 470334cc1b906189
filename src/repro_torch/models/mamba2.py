"""Mamba2 / SSD (state-space duality) blocks (port of ``repro.models.mamba2``).

Chunked SSD forward: the sequence is split into chunks of ``ssm_chunk``; a
loop over chunks carries the (B, H, N, P) inter-chunk state while the
quadratic intra-chunk term is computed per chunk. ``ssd_chunked`` is the
plain version of the SSD kernel (``kernels/ssd.py``): the blocks call
``kernels.ops.ssd``, which runs it on CPU tensors and the kernel on CUDA
tensors.

Head layout: d_inner = H * P is head-major. The reference's
``_ssd_parallel`` (a form for XLA cost analysis only) is not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm
from repro_torch.models.modes import tp_sum


# --------------------------------------------------------------------------- #
# Depthwise causal conv (k=4) in the reference's shift-and-sum form
# --------------------------------------------------------------------------- #
def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (C, k). Causal depthwise conv + SiLU."""
    k = w.shape[-1]
    s = x.shape[1]
    out = x * w[:, k - 1]
    for i in range(k - 1):
        shift = k - 1 - i
        if shift < s:
            out[:, shift:] += x[:, :s - shift] * w[:, i]
    return F.silu(out)


def causal_conv_step(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x: (B, 1, C); state: (B, k-1, C). Returns (y, new_state)."""
    window = torch.cat([state, x], dim=1)                  # (B, k, C)
    y = torch.einsum("bkc,ck->bc", window, w)[:, None, :]  # (B, 1, C)
    return F.silu(y), window[:, 1:, :]


# --------------------------------------------------------------------------- #
# Core SSD
# --------------------------------------------------------------------------- #
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); dt: (B, S, H) post-softplus; a: (H,) negative;
    b/c: (B, S, N) (one SSD group); initial_state: (B, H, N, P) fp32.
    Returns (y: (B, S, H, P) in x's dtype, final_state: (B, H, N, P) fp32)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc = (s + pad) // chunk

    xc = x.reshape(bsz, nc, chunk, h, p).float()
    dtc = dt.float().reshape(bsz, nc, chunk, h)
    bc = b_mat.float().reshape(bsz, nc, chunk, n)
    cc = c_mat.float().reshape(bsz, nc, chunk, n)
    af = a.float()
    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]

    ys = []
    for ci in range(nc):
        x_k, dt_k, b_k, c_k = xc[:, ci], dtc[:, ci], bc[:, ci], cc[:, ci]
        da = dt_k * af                                          # (B,Lc,H), <= 0
        cs = torch.cumsum(da, dim=1)                            # inclusive
        # intra-chunk quadratic term. The exponent is masked before exp, where
        # the reference masks after it: for j > i it can pass fp32's range
        # (a chunk of 256 at full width), and the gradient of the masked
        # exp(+inf) is 0 * inf = NaN. The values are the same.
        cb = torch.einsum("bin,bjn->bij", c_k, b_k)             # (B,Lc,Lc)
        seg = torch.where(causal, cs[:, :, None, :] - cs[:, None, :, :], -torch.inf)
        att = cb[..., None] * torch.exp(seg) * dt_k[:, None, :, :]   # (B,i,j,H)
        y = torch.einsum("bijh,bjhp->bihp", att, x_k)
        # inter-chunk contribution from the carried state
        y = y + torch.einsum("bin,bhnp->bihp", c_k, state) * torch.exp(cs)[..., None]
        # state update
        last = cs[:, -1:, :]                                    # (B,1,H)
        w = dt_k * torch.exp(last - cs)                         # (B,Lc,H)
        chunk_state = torch.einsum("bjh,bjn,bjhp->bhnp", w, b_k, x_k)
        state = torch.exp(last[:, 0, :])[:, :, None, None] * state + chunk_state
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, nc * chunk, h, p)
    return y[:, :s].to(x.dtype), state


def ssd_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_vec: torch.Tensor, c_vec: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent decode step. x: (B, H, P); dt: (B, H); a: (H,);
    b/c: (B, N); state: (B, H, N, P) fp32. Returns (y: (B, H, P), state).
    The state is updated in place (the reference returns a new array):
    decode keeps one state buffer per layer instead of a copy per step."""
    dtf = dt.float()
    decay = torch.exp(dtf * a.float())                            # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhnp", dtf, b_vec.float(), x.float())
    state.mul_(decay[:, :, None, None]).add_(upd)
    y = torch.einsum("bn,bhnp->bhp", c_vec.float(), state)
    return y.to(x.dtype), state


# --------------------------------------------------------------------------- #
# Full Mamba2 block
# --------------------------------------------------------------------------- #
FP32_LEAVES = ("a_log", "d_skip", "dt_bias")   # fp32 whatever the model dtype


def mamba_shapes(cfg) -> Dict[str, tuple]:
    """Shapes of one block's parameters, in the reference's tree order."""
    d, inner = cfg.d_model, cfg.ssm_inner
    h, n, k = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv_kernel
    return {"w_x": (d, inner), "w_z": (d, inner), "w_b": (d, n), "w_c": (d, n),
            "w_dt": (d, h), "conv_x": (inner, k), "conv_b": (n, k), "conv_c": (n, k),
            "a_log": (h,), "d_skip": (h,), "dt_bias": (h,), "norm": (inner,),
            "out": (inner, d)}


@torch.no_grad()
def mamba_init(p: Dict[str, torch.Tensor], cfg, generator: torch.Generator) -> None:
    """Fill one block's parameters in place with the reference's
    distributions: fan-in scaled projections, N(0, 1/k) conv taps,
    a_log = log(linspace(1, 16, H)), d_skip = 1, zero norm, and dt_bias the
    inverse softplus of numpy's ``RandomState(0)`` draw, as the reference."""
    d, inner, h, k = cfg.d_model, cfg.ssm_inner, cfg.ssm_heads, cfg.ssm_conv_kernel
    sc = 1.0 / np.sqrt(d)
    scales = {"w_x": sc, "w_z": sc, "w_b": sc, "w_c": sc, "w_dt": sc,
              "conv_x": 1.0 / np.sqrt(k), "conv_b": 1.0 / np.sqrt(k),
              "conv_c": 1.0 / np.sqrt(k), "out": 1.0 / np.sqrt(inner)}
    for name, scale in scales.items():
        w = p[name]
        w.copy_(torch.randn(w.shape, generator=generator, device=generator.device) * scale)
    dt = np.exp(np.random.RandomState(0).uniform(np.log(1e-3), np.log(0.1), h))
    dt_bias = dt + np.log(-np.expm1(-dt))  # inverse softplus
    p["a_log"].copy_(torch.from_numpy(np.log(np.linspace(1.0, 16.0, h))))
    p["d_skip"].fill_(1.0)
    p["dt_bias"].copy_(torch.from_numpy(dt_bias))
    p["norm"].zero_()


def _mamba_projections(p: Dict, x: torch.Tensor):
    z = x @ p["w_z"]
    xr = x @ p["w_x"]
    br = x @ p["w_b"]
    cr = x @ p["w_c"]
    dt_raw = x @ p["w_dt"]
    return z, xr, br, cr, dt_raw


def _gate_out(p: Dict, cfg, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor
              ) -> torch.Tensor:
    """D skip, gate by silu(z), RMSNorm over the whole inner width, output
    projection (this rank's partial sum where the heads are split)."""
    bsz, s = z.shape[:2]
    y = y + (p["d_skip"].float()[:, None] * xh.float()).to(y.dtype)
    y = y.reshape(bsz, s, -1) * F.silu(z)
    if p["norm"].shape[0] == cfg.ssm_inner:
        y = rms_norm(y, p["norm"])
    else:
        y = _split_rms_norm(y, p["norm"], cfg.ssm_inner)
    return y @ p["out"]


def _split_rms_norm(x: torch.Tensor, scale: torch.Tensor, width: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` of a tensor whose last dim (``width`` in all) is split
    over "model": the mean of squares sums every rank's block (``tp_sum``)."""
    dtype = x.dtype
    x = x.float()
    var = tp_sum(x.square().sum(dim=-1, keepdim=True)) / width
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def _ssd_inputs(p: Dict, cfg, xr, dt_raw):
    """The SSD's x (B, S, H, P), dt and a, for the heads that the leaves
    hold (all, or this rank's under tensor parallelism)."""
    bsz, s = xr.shape[:2]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    return xr.reshape(bsz, s, -1, cfg.ssm_head_dim), dt, a


def mamba_apply(p: Dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward. x: (B, S, D). The SSD runs through
    ``kernels.ops.ssd``: the kernel on CUDA, ``ssd_chunked`` on the CPU, and
    under autograd the gradient of ``ssd_chunked`` on both (the training
    call site: the reference trains through ``ssd_chunked``)."""
    z, xr, br, cr, dt_raw = _mamba_projections(p, x)
    xr = causal_conv(xr, p["conv_x"])
    br = causal_conv(br, p["conv_b"])
    cr = causal_conv(cr, p["conv_c"])
    xh, dt, a = _ssd_inputs(p, cfg, xr, dt_raw)
    y, _ = ops.ssd(xh, dt, a, br, cr, chunk=cfg.ssm_chunk)
    return _gate_out(p, cfg, y, xh, z)


def mamba_state_specs(cfg, batch: int) -> Dict[str, torch.Tensor]:
    """Meta tensors of a single block's decode state (conv windows + SSD
    state). The windows are bf16 here whatever the model dtype, as in the
    reference; ``mamba_prefill`` returns them in the activation dtype."""
    inner, n, k = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_conv_kernel
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return {"conv_x": meta((batch, k - 1, inner), torch.bfloat16),
            "conv_b": meta((batch, k - 1, n), torch.bfloat16),
            "conv_c": meta((batch, k - 1, n), torch.bfloat16),
            "ssm": meta((batch, h, n, pdim), torch.float32)}


def mamba_decode(p: Dict, cfg, x: torch.Tensor, state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, D); state per ``mamba_state_specs``.
    Updates the state tensors in place and returns (out, state)."""
    z, xr, br, cr, dt_raw = _mamba_projections(p, x)
    xr, conv_x = causal_conv_step(xr, p["conv_x"], state["conv_x"])
    br, conv_b = causal_conv_step(br, p["conv_b"], state["conv_b"])
    cr, conv_c = causal_conv_step(cr, p["conv_c"], state["conv_c"])
    for name, window in (("conv_x", conv_x), ("conv_b", conv_b), ("conv_c", conv_c)):
        state[name].copy_(window)
    xh, dt, a = _ssd_inputs(p, cfg, xr, dt_raw)
    y, _ = ssd_step(xh[:, 0], dt[:, 0], a, br[:, 0], cr[:, 0], state["ssm"])
    return _gate_out(p, cfg, y[:, None], xh, z), state


def mamba_prefill(p: Dict, cfg, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward that also returns the decode state at the end
    of the sequence: the last k-1 *pre-conv* inputs (left-padded with zeros
    when S < k-1) and the final SSD state."""
    s = x.shape[1]
    k = cfg.ssm_conv_kernel
    z, xr_raw, br_raw, cr_raw, dt_raw = _mamba_projections(p, x)

    def window(t):
        w = t[:, -(k - 1):, :] if s >= k - 1 else t
        return F.pad(w, (0, 0, max(k - 1 - s, 0), 0))
    xr = causal_conv(xr_raw, p["conv_x"])
    br = causal_conv(br_raw, p["conv_b"])
    cr = causal_conv(cr_raw, p["conv_c"])
    xh, dt, a = _ssd_inputs(p, cfg, xr, dt_raw)
    y, final_state = ops.ssd(xh, dt, a, br, cr, chunk=cfg.ssm_chunk)
    state = {"conv_x": window(xr_raw), "conv_b": window(br_raw),
             "conv_c": window(cr_raw), "ssm": final_state}
    return _gate_out(p, cfg, y, xh, z), state
