"""VLM backbone, the llava-next-mistral family (twin of `repro/models/vlm.py`):
patch embeddings + the dense decoder.

The vision frontend (CLIP-L/336, anyres tiling, projector) is a stub, as in
the reference: the batch carries precomputed patch embeddings
"patch_embeds" [B, num_image_tokens, d_model] (`registry.input_specs` draws
them), which go before the token embeddings through the dense stack of
`transformer.py`.  Parameters and the decode cache are the dense family's;
decode is the dense decode.  `dist` goes on to the dense stack, as the
reference's does.
"""

from __future__ import annotations

import torch

from . import transformer
from .layers import embed

init_params = transformer.init_params
init_cache = transformer.init_cache
decode_step = transformer.decode_step


def _splice(cfg, params, batch):
    """[patch_embeds | token_embeds] -> x [B, n_img + S_text, d]."""
    tok = embed(params["embed"], batch["tokens"]).to(cfg.torch_dtype)
    return torch.cat([batch["patch_embeds"].to(cfg.torch_dtype), tok], dim=1)


def forward(cfg, params, batch, dist=None):
    return transformer.forward_embeds(cfg, params, _splice(cfg, params, batch), dist)


def prefill(cfg, params, batch, cache, dist=None):
    """Prompt = image patches + text tokens; fills the cache with both."""
    return transformer.prefill_embeds(cfg, params, _splice(cfg, params, batch), cache, dist)
