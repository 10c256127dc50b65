"""qwen3-8b [dense] — 36L d=4096 32H (GQA kv=8, head_dim 128, qk-norm)
d_ff=12288 vocab=151936, the counterpart of ``repro/configs/qwen3_8b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12288,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1000000.0,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        head_dim=16, qk_norm=True)
