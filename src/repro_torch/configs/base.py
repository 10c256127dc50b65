"""Architecture configuration schema, the counterpart of
``repro/configs/base.py``.

The reference's module imports ``jax.numpy`` for :attr:`ArchConfig.dtype_`,
so the port keeps its own copy; ``dtype_`` returns a ``torch.dtype``.  Only
the fields of the families the port builds (dense, hybrid, ssm) are carried
over; the reference's MoE, MLA and cross-attention records come with their
families.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma/Griffin: pattern of recurrent and local-attn blocks."""
    lru_width: int = 0           # defaults to d_model
    window: int = 2048
    pattern_period: int = 3      # 2 recurrent + 1 local-attention
    conv_width: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|vlm|audio|hybrid|ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None         # default d_model // n_heads
    qk_norm: bool = False                  # qwen3
    act: str = "silu"                      # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    hybrid: Optional[HybridConfig] = None
    scale_embed: bool = False              # gemma-style sqrt(d) embed scale

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype_(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
