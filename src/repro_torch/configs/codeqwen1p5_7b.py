"""codeqwen1.5-7b — qwen1.5 architecture, code model.

[hf Qwen/CodeQwen1.5-7B]  32L d_model=4096, 32H (GQA kv=32 => MHA),
d_ff=13440, vocab=92416, qkv bias (qwen1.5 family trait).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416, qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="codeqwen1.5-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, qkv_bias=True, dtype="float32",
)
