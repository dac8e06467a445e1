"""Mamba2-780M [arXiv:2405.21060; unverified]: pure SSD, attention-free.

Assignment: 48L d_model=1536 d_ff=0 vocab=50280 ssm_state=128.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_head=64,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
)
