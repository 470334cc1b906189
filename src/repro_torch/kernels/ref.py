"""Plain PyTorch oracles for the kernels (assert_allclose targets), as
``repro.kernels.ref``. ``decode_attention_ref`` is also what
``kernels.ops`` runs on CPU tensors in place of the decode kernel."""
from __future__ import annotations

import torch


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
