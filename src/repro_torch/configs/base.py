"""Architecture configuration schema, the counterpart of
``repro/configs/base.py``.

The reference's module imports ``jax.numpy`` for :attr:`ArchConfig.dtype_`,
so the port keeps its own copy; ``dtype_`` returns a ``torch.dtype``.  The
fields of every family the port builds (dense, hybrid, ssm, the MoE family
with GQA or MLA attention, the vlm's cross-attention layers and whisper's
encoder) are carried over.  :class:`ShapeConfig`,
:data:`LM_SHAPES` and :class:`TrainConfig` are the reference's, field for
field; the port's trainer reads ``microbatch``, ``remat``, ``optimizer``,
``adam_dtype``, ``xent_chunks``, ``lr``, ``weight_decay``, ``grad_clip`` and
``seed``, and the sharding knobs (``zero_stage``, ``grad_compression``,
``act_shard``, ``fence_scope``) wait for the port's distributed binding.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    first_k_dense: int = 0       # leading dense layers (deepseek-v3: 3)
    d_ff_dense: int = 0          # FFN width of dense (non-MoE) layers
    moe_every_k: int = 1         # MoE every k-th layer (llama4-maverick: 2)
    capacity_factor: float = 1.25
    router_impl: str = "a2a"     # 'a2a' (sorted all-to-all EP) | 'dense'


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma/Griffin: pattern of recurrent and local-attn blocks."""
    lru_width: int = 0           # defaults to d_model
    window: int = 2048
    pattern_period: int = 3      # 2 recurrent + 1 local-attention
    conv_width: int = 4


@dataclass(frozen=True)
class CrossAttnConfig:
    """VLM (llama3.2-vision) / enc-dec (whisper) cross-attention."""
    every_k: int = 5             # vlm: cross-attn layer every k layers
    n_context_tokens: int = 1601  # stubbed frontend sequence length
    context_dim: int = 0         # 0 → d_model


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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    hybrid: Optional[HybridConfig] = None
    cross: Optional[CrossAttnConfig] = None
    n_enc_layers: int = 0                  # whisper encoder stack
    mtp_depth: int = 0                     # deepseek multi-token prediction
    scale_embed: bool = False              # gemma-style sqrt(d) embed scale

    def is_moe_layer(self, i: int) -> bool:
        mo = self.moe
        if mo is None:
            return False
        return (i >= mo.first_k_dense
                and (i % mo.moe_every_k) == (mo.moe_every_k - 1))

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype_(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One (arch × shape) benchmark cell."""
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                   # 'train' | 'prefill' | 'decode'


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


@dataclass(frozen=True)
class TrainConfig:
    """Run-level knobs threaded through train/serve steps."""
    microbatch: int = 0              # 0 → no gradient accumulation
    remat: str = "block"             # none | block | full
    optimizer: str = "adamw"         # adamw | adafactor
    adam_dtype: str = "float32"      # moment dtype (bf16 for giant MoEs)
    zero_stage: int = 2              # 0: replicated opt state; 2/3: sharded
    grad_compression: str = "none"   # none | int8ef
    xent_chunks: int = 1             # chunk the unembed+loss (memory knob)
    act_shard: str = "none"          # none | replicated | seq (Megatron-SP)
    fence_scope: str = "global"      # global | pair  (paper §5.3 knob)
    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
