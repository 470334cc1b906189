"""Architecture & shape registry (the port's own copy of ``repro.configs``).

Configs are pure data. The port keeps its own copy so that it never imports
the JAX package; only the configs the port can build are registered.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Dict, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ArchConfig:
    """One architecture. All sizes are the *full* production config. The
    fields are the reference's, in its order."""

    name: str
    family: str  # "dense", "moe", "vlm", "ssm", "hybrid" or "encdec"
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
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256
    # --- hybrid (Zamba2-style): one shared attention block every k layers ---
    attn_every: int = 0
    # --- encoder-decoder (Whisper): precomputed frame embeddings (conv frontend stubbed) ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    # --- VLM (InternVL2): precomputed patch embeddings (ViT frontend stubbed) ---
    num_patch_tokens: int = 0
    # --- numerics / memory ---
    dtype: str = "bfloat16"
    # none | full | dots: the recompute of a layer body in the backward
    # (models.modes.run_layer), which roofline.memory_model counts
    remat_policy: str = "full"
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
    def padded_experts(self) -> int:
        """Experts padded to a multiple of 16 (even shards over an expert
        axis of 16); the router masks the pads out."""
        return _round_up(self.num_experts, 16) if self.num_experts else 0

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for the decoder stack: a hybrid's layer i is
        followed by the shared attention block when i % attn_every ==
        attn_every - 1 (``mamba_attn``)."""
        if self.family == "ssm":
            return ("mamba",) * self.num_layers
        if self.family == "hybrid":
            k = self.attn_every
            return tuple("mamba_attn" if i % k == k - 1 else "mamba"
                         for i in range(self.num_layers))
        return ("attn",) * self.num_layers


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

# The ten assigned architectures (dry-run and roofline targets).
ASSIGNED: Tuple[str, ...] = (
    "deepseek-67b",
    "qwen3-0.6b",
    "nemotron-4-15b",
    "gemma-2b",
    "whisper-small",
    "mamba2-2.7b",
    "zamba2-7b",
    "qwen3-moe-30b-a3b",
    "qwen2-moe-a2.7b",
    "internvl2-26b",
)

# The paper's own evaluation workloads (Table 4).
PAPER_WORKLOADS: Tuple[str, ...] = (
    "gpt2-2.7b",
    "llama3-8b",
    "llama2-13b",
    "llama3-70b",
)

# The config modules, the JAX registry's eleven in its order: the dense ones,
# the enc-dec one, mamba2, zamba2, the two MoE ones, the VLM and the paper's
# workloads.
_MODULES = ("deepseek_67b", "qwen3_0_6b", "nemotron_4_15b", "gemma_2b",
            "whisper_small", "mamba2_2_7b", "zamba2_7b", "qwen3_moe_30b_a3b",
            "qwen2_moe_a2_7b", "internvl2_26b", "paper_workloads")


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


def list_archs() -> Tuple[str, ...]:
    if not _REGISTRY:
        _load_all()
    return tuple(sorted(_REGISTRY))


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}") from None


def dryrun_cells(include_skips: bool = False):
    """All (arch, shape, skip) dry-run cells of the assigned architectures;
    ``skip`` marks long_500k for a full-attention arch, which is left out
    unless ``include_skips``."""
    cells = []
    for arch_name in ASSIGNED:
        cfg = get_arch(arch_name)
        for shape in SHAPES.values():
            skip = shape.requires_sub_quadratic and not cfg.sub_quadratic
            if skip and not include_skips:
                continue
            cells.append((cfg, shape, skip))
    return cells


def reduce_for_smoke(cfg: ArchConfig, *, seq_hint: int = 32) -> ArchConfig:
    """Shrink a production config to a CPU-smoke-testable size, by the rules
    of ``repro.configs.reduce_for_smoke`` (no recompute: ``remat_policy``
    "none"): an MoE keeps 8 experts (padded to
    16), top-k of at most 2 and its shared expert; a hybrid keeps 4 layers
    and its attention cadence (every 2); an enc-dec keeps both stacks, 2
    encoder layers of max(8, seq_hint // 2) frames; a VLM keeps 8 patch
    tokens."""
    if cfg.num_kv_heads == 1:
        kv_heads = 1
    elif cfg.num_kv_heads < cfg.num_heads:
        kv_heads = min(cfg.num_kv_heads, 2)
    else:
        kv_heads = 4
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 4 if cfg.family == "hybrid" else 2),
        d_model=64, num_heads=4, num_kv_heads=kv_heads, head_dim=16,
        d_ff=128 if cfg.d_ff else 0, vocab_size=256, remat_policy="none")
    if cfg.is_moe:
        changes.update(num_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=32)
        if cfg.num_shared_experts:
            changes.update(num_shared_experts=2, shared_expert_d_ff=32)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.family == "hybrid":
        changes.update(attn_every=2)
    if cfg.encoder_layers:
        changes.update(encoder_layers=2, encoder_seq=max(8, seq_hint // 2))
    if cfg.num_patch_tokens:
        changes.update(num_patch_tokens=8)
    return dataclasses.replace(cfg, **changes)
