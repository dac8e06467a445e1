"""Zamba2-1.2B [arXiv:2411.15242; hf]: Mamba2 backbone + shared attention block.

Assignment: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000 ssm_state=64.
The shared attention block operates on concat([h, embed]) (width 2*d_model)
every 6 mamba blocks, as in the Zamba2 design.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=128,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_every=6,
)
