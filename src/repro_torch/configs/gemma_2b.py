"""gemma-2b [dense] — 18L d=2048 8H (MQA kv=1) head_dim=256 GeGLU d_ff=16384
vocab=256000, the counterpart of ``repro/configs/gemma_2b.py``.
[arXiv:2403.08295; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=256000, head_dim=256, act="gelu", rope_theta=10000.0,
    tie_embeddings=True, scale_embed=True,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=256,
        head_dim=32, act="gelu", tie_embeddings=True)
