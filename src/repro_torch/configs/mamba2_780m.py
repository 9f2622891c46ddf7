"""mamba2-780m — pure SSD (state-space duality), attention-free.

[arXiv:2405.21060; hf state-spaces/mamba2-780m; unverified tier]
48L d_model=1536, d_inner=2*d_model, ssm_state=128, head_dim=64, conv=4,
vocab=50280 (gpt-neox tokenizer padded).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=3, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=512,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4, ssm_chunk=32,
    dtype="float32",
)
