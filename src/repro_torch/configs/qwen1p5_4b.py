"""Qwen1.5-4B [hf:Qwen/Qwen1.5-*; hf]: MHA with QKV bias.

Assignment: 40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_head=128,
    d_ff=6912, vocab=151936, qkv_bias=True,
)
