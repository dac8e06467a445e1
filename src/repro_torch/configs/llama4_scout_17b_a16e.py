"""Llama-4 Scout 17B-A16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Assignment: 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 16e top-1 + shared expert (early-fusion multimodal out of scope; the
text backbone is what the shape set exercises).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=202048,
    n_experts=16, n_shared_experts=1, moe_top_k=1, d_ff_expert=8192,
    n_dense_layers=0,
)
