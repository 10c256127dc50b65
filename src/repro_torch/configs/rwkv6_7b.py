"""rwkv6-7b (Finch) [ssm] — 32L d=4096 attention-free (64 heads of size 64),
channel-mix d_ff=14336, vocab=65536, data-dependent decay, the counterpart
of ``repro/configs/rwkv6_7b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab=65536, head_dim=64, sub_quadratic=True, norm_eps=1e-5,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        head_dim=16, sub_quadratic=True, norm_eps=1e-5)
