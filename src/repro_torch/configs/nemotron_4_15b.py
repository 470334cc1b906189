"""Nemotron-4-15B — dense, GQA, squared-ReLU MLP [arXiv:2402.16819; unverified]."""
from repro_torch.configs import ArchConfig, register

register(ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="sq_relu",    # squared-ReLU, ungated: w_up (D,F) + w_down (F,D)
    source="arXiv:2402.16819; unverified",
))
