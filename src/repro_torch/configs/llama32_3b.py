"""llama3.2-3b [dense] — 28L d=3072 24H (GQA kv=8) d_ff=8192 vocab=128256,
the counterpart of ``repro/configs/llama32_3b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab=128256, rope_theta=500000.0, tie_embeddings=True,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama32-3b-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96, vocab=256,
        tie_embeddings=True)
