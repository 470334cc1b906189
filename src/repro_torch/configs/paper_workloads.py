"""The paper's own evaluation workloads (FFTrainer Table 4)."""
from repro_torch.configs import ArchConfig, register

register(ArchConfig(
    name="gpt2-2.7b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=50257, mlp_type="gelu",
    source="paper Table 4 (GPT-2 2.7B)",
))
register(ArchConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, mlp_type="swiglu", rope_theta=500_000.0,
    source="paper Table 4 (LLaMA3-8B)",
))
register(ArchConfig(
    name="llama2-13b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=40, head_dim=128,
    d_ff=13824, vocab_size=32000, mlp_type="swiglu",
    source="paper Table 4 (LLaMA2-13B)",
))
register(ArchConfig(
    name="llama3-70b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, mlp_type="swiglu", rope_theta=500_000.0,
    source="paper Table 4 (LLaMA3-70B)",
))
