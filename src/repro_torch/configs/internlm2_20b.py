"""internlm2-20b [dense] — 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92544,
the counterpart of ``repro/configs/internlm2_20b.py``.
[arXiv:2403.17297; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92544, rope_theta=1000000.0,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="internlm2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
