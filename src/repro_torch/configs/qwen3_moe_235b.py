"""qwen3-moe-235b-a22b — 128-expert top-8 MoE.

[hf Qwen/Qwen3-235B-A22B; family verified via Qwen/Qwen3-30B-A3B]
94L d_model=4096, 64H (GQA kv=4), per-expert d_ff=1536, vocab=151936,
128 routed experts top-8, norm_topk_prob, no shared experts.  head_dim=128
(explicit in the qwen3 family, != d_model/num_heads).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, rope_theta=1_000_000.0,
    num_experts=128, experts_per_tok=8, moe_d_ff=1536, norm_topk_prob=True,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512,
    num_experts=8, experts_per_tok=2, moe_d_ff=96, dtype="float32",
)
