"""llava-next-mistral-7b — VLM, Mistral-7B text backbone.

[hf llava-hf/llava-v1.6-mistral-7b-hf; unverified tier]  Backbone: 32L
d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=32000 (+image tokens).
AnyRes tiling frontend (CLIP-L/336 + 2x2 grid + base) is STUBBED:
input_specs() supplies precomputed patch embeddings [B, num_image_tokens,
d_model]; num_image_tokens=1176 ~ one 336px tile + newline tokens x 2
(conservative anyres budget that keeps seq_len=4096 cells well-formed).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, rope_theta=1_000_000.0,
    num_image_tokens=1176,
)

SMOKE = ModelConfig(
    name="llava-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, num_image_tokens=16, dtype="float32",
)
