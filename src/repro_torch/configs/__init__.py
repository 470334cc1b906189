"""Architecture & shape registry (the port's own copy of ``repro.configs``).

Configs are pure data. The port keeps its own copy so that it never imports
the JAX package; only the configs the port can build are registered.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Dict


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ArchConfig:
    """One architecture. All sizes are the *full* production config. Only
    the fields the ported families read are kept; each later slice adds the
    fields of the families it ports."""

    name: str
    family: str  # "dense" and "ssm" build; the others name their ROADMAP item
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- MLP / norm flavor ---
    mlp_type: str = "swiglu"  # swiglu | geglu | sq_relu | gelu
    use_qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256
    # --- numerics ---
    dtype: str = "bfloat16"
    # --- capability flags ---
    sub_quadratic: bool = False  # can run long_500k
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron-style)."""
        return _round_up(self.vocab_size, 256)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim if self.ssm_state else 0


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    requires_sub_quadratic: bool = False


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode",
                             requires_sub_quadratic=True),
}

_REGISTRY: Dict[str, ArchConfig] = {}

# Config modules ported so far: the dense ones and mamba2 (the JAX registry
# loads twelve modules; the MoE, hybrid, enc-dec and VLM ones wait for their
# families, ROADMAP items 10 and 11).
_MODULES = ("deepseek_67b", "qwen3_0_6b", "nemotron_4_15b", "gemma_2b",
            "mamba2_2_7b", "paper_workloads")


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    for mod in _MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Shrink a production config to a CPU-smoke-testable size, by the rules
    of ``repro.configs.reduce_for_smoke`` for the dense and SSM families."""
    if cfg.num_kv_heads == 1:
        kv_heads = 1
    elif cfg.num_kv_heads < cfg.num_heads:
        kv_heads = min(cfg.num_kv_heads, 2)
    else:
        kv_heads = 4
    changes = dict(
        name=cfg.name + "-smoke", num_layers=min(cfg.num_layers, 2),
        d_model=64, num_heads=4, num_kv_heads=kv_heads, head_dim=16,
        d_ff=128 if cfg.d_ff else 0, vocab_size=256)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    return dataclasses.replace(cfg, **changes)
