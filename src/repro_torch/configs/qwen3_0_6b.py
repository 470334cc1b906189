"""Qwen3-0.6B — dense, qk-norm, GQA [hf:Qwen/Qwen3-0.6B]."""
from repro_torch.configs import ArchConfig, register

register(ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,          # Qwen3 uses head_dim 128 (q proj widens to 2048)
    d_ff=3072,
    vocab_size=151936,
    mlp_type="swiglu",
    use_qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-0.6B; hf",
))
