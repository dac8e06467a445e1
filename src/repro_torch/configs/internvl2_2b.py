"""InternVL2-2B [arXiv:2404.16821; hf]: InternViT frontend + InternLM2 backbone.

Assignment: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
Per the shape-pool spec the ViT frontend is a STUB: input_specs() supplies
precomputed patch embeddings (dim 1024, 256 patches) that a projector maps
into the LM embedding space; the LM backbone is fully implemented.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=92553,
    frontend="vision", frontend_dim=1024, n_patches=256,
)
