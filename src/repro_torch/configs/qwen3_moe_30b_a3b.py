"""Qwen3-30B-A3B — MoE, 128 experts top-8, qk-norm [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs import ArchConfig, register

register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,                 # every MLP is MoE
    vocab_size=151936,
    mlp_type="swiglu",
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    top_k=8,
    moe_d_ff=768,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
