"""Zamba2-7B — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242; unverified].

Modeling note (the reference's): the shared transformer block (weights shared
across all its applications) is applied every ``attn_every`` layers within the
Mamba2 stack; the real model interleaves two shared blocks — we use one shared
block at the same cadence, which preserves the parameter-sharing structure the
checkpoint razor must handle."""
from repro_torch.configs import ArchConfig, register

register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,        # MHA in the shared block
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,        # d_inner = 7168 -> 112 SSD heads
    ssm_expand=2,
    attn_every=6,
    sub_quadratic=True,
    source="arXiv:2411.15242; unverified",
))
