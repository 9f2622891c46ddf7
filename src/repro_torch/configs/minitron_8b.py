"""minitron-8b — dense, pruned from Nemotron-4 15B.

[arXiv:2407.14679; hf nvidia/Minitron-8B-Base]  32L d_model=4096, 48H->32H
(GQA kv=8), d_ff=16384, vocab=256000 (the large sentencepiece vocab makes the
embedding the dominant parameter block: sharded over model AND data axes).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000, rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="minitron-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, dtype="float32",
)
