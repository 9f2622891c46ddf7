"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone.

[arXiv:2308.11596; hf facebook/seamless-m4t-v2-large]  Backbone only:
24L encoder + 24L decoder, d_model=1024, 16H (kv=16), d_ff=8192,
vocab=256206.  The audio frontend (w2v-BERT conformer feature extractor) is
STUBBED per the assignment: input_specs() supplies precomputed frame
embeddings [B, S_enc, d_model]; the decoder is a standard causal LM with
cross-attention.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, encoder_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, d_ff=8192, vocab_size=256206,
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec",
    num_layers=2, encoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, dtype="float32",
)
