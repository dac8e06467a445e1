"""DeepSeek-V3 671B [arXiv:2412.19437; hf]: MLA + 1 shared + 256 routed top-8 MoE.

Assignment: 61L d_model=7168 128H (GQA kv=128) d_ff=2048 vocab=129280,
MoE 256e top-8. MLA dims from the DeepSeek-V3 report (q_lora 1536, kv_lora 512,
qk_nope 128, qk_rope 64, v_head 128); first 3 layers dense (d_ff_dense 18432).
MTP (multi-token prediction) head is out of scope (noted in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_head=128,
    d_ff=18432,            # dense-layer FFN width (DeepSeek-V3 report)
    vocab=129280,
    n_experts=256, n_shared_experts=1, moe_top_k=8, d_ff_expert=2048,
    n_dense_layers=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
)
