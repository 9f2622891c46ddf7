"""qwen2.5-32b — dense GQA with QKV bias.

[hf Qwen/Qwen2.5-32B; config verified against the Qwen2.5 family]
64L d_model=5120, 40H (GQA kv=8), d_ff=27648, vocab=152064, qkv bias.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152064, qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=512, qkv_bias=True, dtype="float32",
)
