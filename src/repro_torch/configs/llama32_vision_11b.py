"""llama-3.2-vision-11b [vlm] — 40L d=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers every 5th layer; patch-embedding
frontend stubbed (the model takes the context embeddings), the counterpart
of ``repro/configs/llama32_vision_11b.py``.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ArchConfig, CrossAttnConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, rope_theta=500000.0,
    cross=CrossAttnConfig(every_k=5, n_context_tokens=1601, context_dim=0),
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama32-vision-smoke", family="vlm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256,
        cross=CrossAttnConfig(every_k=2, n_context_tokens=16, context_dim=0))
