"""Mamba2-2.7B — attention-free SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.configs import ArchConfig, register

register(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                 # Mamba2 blocks replace both attention and MLP
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,        # d_inner = 2*2560 = 5120 -> 80 SSD heads
    ssm_expand=2,
    sub_quadratic=True,
    source="arXiv:2405.21060; unverified",
))
