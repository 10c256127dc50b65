"""recurrentgemma-2b [hybrid] — 26L d=2560 10H (MQA kv=1, head_dim 256)
d_ff=7680 GeGLU, RG-LRU + local attention 1:2 (pattern: rec, rec, attn),
window 2048, the counterpart of ``repro/configs/recurrentgemma_2b.py``."""
from .base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, act="gelu", rope_theta=10000.0,
    tie_embeddings=True, scale_embed=True, sub_quadratic=True,
    hybrid=HybridConfig(lru_width=2560, window=2048, pattern_period=3,
                        conv_width=4),
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=256,
        head_dim=16, act="gelu", tie_embeddings=True, sub_quadratic=True,
        hybrid=HybridConfig(lru_width=64, window=16, pattern_period=3,
                            conv_width=4))
