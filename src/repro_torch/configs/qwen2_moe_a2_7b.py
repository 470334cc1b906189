"""Qwen1.5-MoE-A2.7B — 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. 60 experts are padded to 64 (router logits
of the pad experts masked; see ArchConfig.padded_experts)."""
from repro_torch.configs import ArchConfig, register

register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    mlp_type="swiglu",
    num_experts=60,
    top_k=4,
    moe_d_ff=1408,
    num_shared_experts=4,
    shared_expert_d_ff=5632,   # 4 shared experts fused into one (D, 4*1408) MLP
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
))
