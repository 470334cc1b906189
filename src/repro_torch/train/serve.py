"""Serving step builders on one device: prefill and cached decode (port of
``repro.train.serve``), for any model with the serving interface below
(``DecoderLM`` with its KV cache, ``MambaLM`` with its recurrent state,
``HybridLM`` with both).

PyTorch runs eagerly, so a step is the model's method under
``torch.inference_mode()``; there is no mesh, sharding plan or jit.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Protocol, Tuple

import torch


class ServingModel(Protocol):
    """What the serve steps call on a model."""

    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]: ...

    def decode_step(self, cache: Dict, token: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]: ...


def build_prefill_step(model: ServingModel) -> Callable:
    """prefill(tokens (B, S), max_len) -> (fp32 logits (B, V), cache)."""

    @torch.inference_mode()
    def prefill(tokens: torch.Tensor, max_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        return model.prefill(tokens, max_len)

    return prefill


def build_decode_step(model: ServingModel) -> Callable:
    """decode(cache, token (B,)) -> (fp32 logits (B, V), cache). The cache is
    updated in place and returned: the counterpart of the reference's
    ``donate_argnums=(1,)``, which lets XLA reuse the cache buffers."""

    @torch.inference_mode()
    def decode(cache: Dict, token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        return model.decode_step(cache, token)

    return decode
