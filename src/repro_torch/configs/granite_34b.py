"""Granite-34B-Code [arXiv:2405.04324; hf]: deep-narrow llama-arch, MQA (kv=1).

Assignment: 88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
    d_ff=24576, vocab=49152,
)
