"""Serving step builders on one device: prefill and KV-cache decode (port of
``repro.train.serve``).

PyTorch runs eagerly, so a step is the model's method under
``torch.inference_mode()``; there is no mesh, sharding plan or jit.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import DecoderLM


def build_prefill_step(model: DecoderLM) -> Callable:
    """prefill(tokens (B, S), max_len) -> (fp32 logits (B, V), cache)."""

    @torch.inference_mode()
    def prefill(tokens: torch.Tensor, max_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        return model.prefill(tokens, max_len)

    return prefill


def build_decode_step(model: DecoderLM) -> Callable:
    """decode(cache, token (B,)) -> (fp32 logits (B, V), cache). The cache is
    updated in place and returned: the counterpart of the reference's
    ``donate_argnums=(1,)``, which lets XLA reuse the cache buffers."""

    @torch.inference_mode()
    def decode(cache: Dict, token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        return model.decode_step(cache, token)

    return decode
