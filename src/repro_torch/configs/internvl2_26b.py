"""InternVL2-26B — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].
The ViT frontend is a stub: the model takes precomputed patch embeddings
(B, num_patch_tokens, d_model) in front of the prompt; the config is the LM
backbone's."""
from repro_torch.configs import ArchConfig, register

register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    mlp_type="swiglu",
    num_patch_tokens=1024,  # e.g. 4 tiles x 256 patch tokens
    source="arXiv:2404.16821; hf",
))
