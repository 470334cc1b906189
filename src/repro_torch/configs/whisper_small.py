"""Whisper-small — encoder-decoder audio transformer backbone
[arXiv:2212.04356; unverified]. The conv frontend is a stub: the model takes
precomputed frame embeddings (B, encoder_seq, d_model)."""
from repro_torch.configs import ArchConfig, register

register(ArchConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,          # decoder layers
    encoder_layers=12,
    encoder_seq=1500,       # 30 s of audio after the (stubbed) conv frontend
    d_model=768,
    num_heads=12,
    num_kv_heads=12,        # MHA
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    mlp_type="gelu",
    source="arXiv:2212.04356; unverified",
))
