"""Model configuration shared by the whole zoo (10 assigned archs + paper
models): a copy of ``repro.models.config.ModelConfig``, field for field, so
the port reads the same configs."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None            # default d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0                  # leading dense layers (deepseek: 3)
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    attn_every: int = 0                      # hybrid: shared attn block period
    ssm_chunk: int = 256

    # --- modality frontend stubs ---
    frontend: Optional[str] = None           # None | "audio" | "vision"
    frontend_dim: int = 0                    # precomputed embedding dim
    n_patches: int = 0                       # vision: patches prepended per sample

    # --- misc ---
    qkv_bias: bool = False
    causal: bool = True                      # False for encoder-only
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"                  # compute/param dtype
    remat: bool = True                       # activation checkpoint per layer
    unroll: bool = False                     # unroll layer scans (cost probes)
    dp_only: bool = False                    # distribution policy: no TP — use
                                             # the "model" axis as extra DP
                                             # (wins for small-d_model archs)
    # FL / Caesar round structure (Track B)
    local_iters: int = 1                     # τ for cohort-local SGD scan

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:                # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_decode(self) -> bool:
        return self.family != "encoder"

    @property
    def supports_long_context(self) -> bool:
        # 500k decode needs sub-quadratic sequence mixing (SSM/hybrid).
        return self.family in ("ssm", "hybrid")

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 + (2 if self.family == "moe" else 0)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_head=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2),
            d_ff_expert=64 if self.d_ff_expert else 0,
            n_dense_layers=min(self.n_dense_layers, 1),
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_dim=16 if self.qk_nope_dim else 0,
            qk_rope_dim=16 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            dtype="float32",
            remat=False,
        )
