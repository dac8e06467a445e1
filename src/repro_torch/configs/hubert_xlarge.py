"""HuBERT-XLarge [arXiv:2106.07447; unverified]: encoder-only (w2v2 arch).

Assignment: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
Audio frontend is a STUB per the shape-pool spec: input_specs() supplies
precomputed frame embeddings (dim 512); training target is the per-frame
cluster id (masked-prediction proxy), vocab=504 classes.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_head=80,
    d_ff=5120, vocab=504, causal=False,
    frontend="audio", frontend_dim=512,
)
