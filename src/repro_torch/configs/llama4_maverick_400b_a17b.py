"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE on every 2nd layer: 128 routed experts top-1 + 1 shared,
dense FFN (8192) between, the counterpart of
``repro/configs/llama4_maverick_400b_a17b.py``."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, rope_theta=500000.0,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192,
                  n_shared_experts=1, d_ff_shared=8192,
                  moe_every_k=2, d_ff_dense=8192),
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama4-maverick-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128,
                      n_shared_experts=1, d_ff_shared=128,
                      moe_every_k=2, d_ff_dense=128))
