"""Architecture registry of the port: ``--arch <id>`` resolves here.  The
port carries all ten of the reference registry's architectures, under its
ids: the dense family (llama3.2-3b, qwen3-8b, gemma-2b, internlm2-20b),
recurrentgemma (hybrid), rwkv6 (ssm), llama4-maverick and deepseek-v3
(moe), llama-3.2-vision (vlm: gated cross-attention layers over a context)
and whisper (audio: an encoder-decoder)."""
from . import (deepseek_v3_671b, gemma_2b, internlm2_20b,
               llama4_maverick_400b_a17b, llama32_3b, llama32_vision_11b,
               qwen3_8b, recurrentgemma_2b, rwkv6_7b, whisper_large_v3)
from .base import (LM_SHAPES, ArchConfig, CrossAttnConfig, HybridConfig,
                   MLAConfig, MoEConfig, ShapeConfig, TrainConfig,
                   shape_applicable)

_MODULES = {
    "llama3.2-3b": llama32_3b,
    "qwen3-8b": qwen3_8b,
    "gemma-2b": gemma_2b,
    "internlm2-20b": internlm2_20b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "rwkv6-7b": rwkv6_7b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "llama-3.2-vision-11b": llama32_vision_11b,
    "whisper-large-v3": whisper_large_v3,
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    try:
        return _MODULES[arch_id]
    except KeyError:
        raise KeyError(f"architecture {arch_id!r} is not ported; the port "
                       f"has {list(ARCH_IDS)}") from None


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()


__all__ = ["ARCH_IDS", "LM_SHAPES", "ArchConfig", "CrossAttnConfig",
           "HybridConfig", "MLAConfig", "MoEConfig", "ShapeConfig",
           "TrainConfig", "get_config", "get_smoke_config",
           "shape_applicable"]
