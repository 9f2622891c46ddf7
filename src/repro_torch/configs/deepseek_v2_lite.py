"""deepseek-v2-lite-16b — MLA + fine-grained MoE.

[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite]  27L d_model=2048, 16H,
MLA kv_lora_rank=512 (qk_nope=128, qk_rope=64, v_head=128), first layer
dense (d_ff=10944), then MoE: 64 routed experts top-6 + 2 shared experts,
per-expert d_ff=1408, vocab=102400.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400, rope_theta=10_000.0,
    num_experts=64, experts_per_tok=6, num_shared_experts=2,
    moe_d_ff=1408, first_k_dense=1, norm_topk_prob=False,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=160, vocab_size=512,
    num_experts=8, experts_per_tok=2, num_shared_experts=1,
    moe_d_ff=96, first_k_dense=1,
    kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    dtype="float32",
)
