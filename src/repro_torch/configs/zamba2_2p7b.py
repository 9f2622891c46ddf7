"""zamba2-2.7b — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf Zyphra/Zamba2-2.7B]  54L d_model=2560, 32H (GQA kv=32
=> MHA in the shared block), d_ff=10240, vocab=32000, ssm_state=64.  The
shared transformer block (attention + MLP, one weight copy) is applied every
6 mamba layers (9 call sites, each with its own KV cache).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    shared_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4, ssm_chunk=32,
    shared_attn_every=2, dtype="float32",
)
