"""Plain PyTorch oracles for the kernels (assert_allclose targets), as
``repro.kernels.ref``. ``decode_attention_ref`` and ``ssd_ref`` are also
what ``kernels.ops`` runs on CPU tensors in place of the kernels."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Dense masked attention; same math as the prefill kernel. k/v may hold
    fewer (kv) heads than q; they are repeated as ``jnp.repeat`` does."""
    from repro_torch.models.attention import dense_attention, repeat_kv
    h = q.shape[2]
    return dense_attention(q, repeat_kv(k, h), repeat_kv(v, h), causal=causal)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cur_len: int) -> torch.Tensor:
    """The reference's decode call site (``models.attention.decode_attention``)."""
    from repro_torch.models.attention import decode_attention
    return decode_attention(q, k_cache, v_cache, cur_len, q.shape[2])


def ssd_ref(x, dt, a, b_mat, c_mat, *, chunk: int = 256,
            initial_state: Optional[torch.Tensor] = None):
    """Sequential chunked SSD (``models.mamba2.ssd_chunked``): the SSD
    kernel's call site in the reference."""
    from repro_torch.models.mamba2 import ssd_chunked
    return ssd_chunked(x, dt, a, b_mat, c_mat, chunk=chunk, initial_state=initial_state)


def ssd_intra_chunk_ref(x, dt, a, b_mat, c_mat, *, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the SSD kernel alone computes (``_ssd_chunk_kernel``): fp32
    (y_intra (B, S, H, P), chunk_states (B, NC, H, N, P), chunk_decay
    (B, NC, H)), the last chunk zero-padded when S does not divide."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    lc = min(chunk, s)
    nc = -(-s // lc)
    pad = nc * lc - s
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, lc, h, p)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(bsz, nc, lc, h)
    bf = F.pad(b_mat.float(), (0, 0, 0, pad)).reshape(bsz, nc, lc, n)
    cf = F.pad(c_mat.float(), (0, 0, 0, pad)).reshape(bsz, nc, lc, n)
    cs = torch.cumsum(dtf * a.float(), dim=2)                     # (B,NC,Lc,H)
    cb = torch.einsum("bcin,bcjn->bcij", cf, bf)
    idx = torch.arange(lc, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :])
    att = torch.where(causal, cb[..., None] * decay * dtf[:, :, None, :, :], 0.0)
    y = torch.einsum("bcijh,bcjhp->bcihp", att, xf).reshape(bsz, nc * lc, h, p)[:, :s]
    last = cs[:, :, -1:, :]
    w = dtf * torch.exp(last - cs)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchnp", w, bf, xf)
    return y, states, torch.exp(last[:, :, 0, :])


def ssd_recurrent_ref(x, dt, a, b_mat, c_mat, initial_state=None):
    """O(S) token-by-token recurrence: the ground-truth semantics that both
    the chunked form and the kernel must match."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state)
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf = b_mat.float(), c_mat.float()
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af[None, :])                # (B, H)
        upd = torch.einsum("bh,bn,bhp->bhnp", dtf[:, t], bf[:, t], xf[:, t])
        state = decay[..., None, None] * state + upd
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state
