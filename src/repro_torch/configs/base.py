"""Model configuration schema + registry (copy of `repro/configs/base.py`).

The fields and the published configurations of all ten architectures are
the reference's; `jdtype` becomes `torch_dtype`.  `ShapeSpec` and `SHAPES`
are the reference's (arch x shape) cells' shapes, plain data.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"           # params/compute dtype (str: hashable+serializable)
    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert FFN width
    first_k_dense: int = 0            # leading dense layers (deepseek: 1)
    norm_topk_prob: bool = True
    # --- MLA (deepseek) ------------------------------------------------------
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba2) --------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1
    # --- hybrid (zamba2) -------------------------------------------------------
    shared_attn_every: int = 0        # one shared attn+MLP block every k ssm layers
    # --- encdec (seamless) -----------------------------------------------------
    encoder_layers: int = 0
    # --- vlm (llava) -------------------------------------------------------------
    num_image_tokens: int = 0         # patch embeddings prepended (frontend stubbed)
    # --- implementation knobs ----------------------------------------------------
    scan_layers: bool = True
    remat: str = "block"              # none | block
    attn_q_chunk: int = 1024          # XLA blockwise attention chunk
    logits_fp32: bool = True
    moe_capacity_factor: float = 2.0  # EP dispatch buffer over uniform load
    moe_dispatch_int8: bool = False   # quantize the a2a payload (per-row scale)

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def vocab_padded(self) -> int:
        """Embedding/unembedding table rows, padded to a multiple of 128;
        logits columns >= vocab_size are masked in unembed."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # approximate parameter count (embedding included), used for roofline
    def param_count(self) -> int:
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.hd
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            per = (d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + nheads)
                   + d_in * d + 3 * nheads + d)
            return L * per + 2 * V * d + d
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) + (self.num_heads * hd) * d
        if self.kv_lora_rank:  # MLA replaces the KV projections
            qk = self.qk_nope_dim + self.qk_rope_dim
            attn = (d * self.num_heads * qk
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                    + self.num_heads * self.v_head_dim * d)
        mlp_dense = 3 * d * self.d_ff
        per_moe = 0
        if self.num_experts:
            per_moe = (self.num_experts + self.num_shared_experts) * 3 * d * self.moe_d_ff + d * self.num_experts
        n_moe = max(0, L - self.first_k_dense) if self.num_experts else 0
        n_dense = L - n_moe
        total = L * attn + n_dense * mlp_dense + n_moe * per_moe + 2 * L * d
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            ssm_per = (d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + nheads) + d_in * d + 3 * nheads + d)
            n_sites = L // max(1, self.shared_attn_every)
            shared = attn + mlp_dense + 2 * d
            total = L * ssm_per + shared + n_sites * 0 + 2 * d
        if self.family == "encdec":
            enc = self.encoder_layers * (attn + mlp_dense + 2 * d)
            dec = L * (2 * attn + mlp_dense + 3 * d)   # self + cross attention
            total = enc + dec
        total += 2 * V * d + d  # embed + unembed + final norm
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        all_experts = (self.num_experts + self.num_shared_experts)
        active_experts = (self.experts_per_tok + self.num_shared_experts)
        n_moe = max(0, self.num_layers - self.first_k_dense)
        expert_params = n_moe * all_experts * 3 * self.d_model * self.moe_d_ff
        active = n_moe * active_experts * 3 * self.d_model * self.moe_d_ff
        return int(full - expert_params + active)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

_ARCH_MODULES = {
    "minitron-8b": "minitron_8b",
    "qwen2.5-32b": "qwen2p5_32b",
    "codeqwen1.5-7b": "codeqwen1p5_7b",
    "internlm2-1.8b": "internlm2_1p8b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "mamba2-780m": "mamba2_780m",
    "zamba2-2.7b": "zamba2_2p7b",
    "seamless-m4t-large-v2": "seamless_m4t_large",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}


def arch_ids():
    return list(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {arch_ids()}")
    return importlib.import_module(f".{_ARCH_MODULES[name]}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def long_context_supported(cfg: ModelConfig) -> bool:
    """long_500k runs only for the sub-quadratic-context families (ssm, hybrid)."""
    return cfg.family in ("ssm", "hybrid")
