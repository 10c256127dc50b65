"""whisper-large-v3 [audio] — enc-dec, 32L encoder + 32L decoder, d=1280
20H d_ff=5120 vocab=51866; conv frontend stubbed (the model takes
precomputed frame embeddings, 1500 frames), the counterpart of
``repro/configs/whisper_large_v3.py``.  [arXiv:2212.04356; unverified]"""
from .base import ArchConfig, CrossAttnConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, act="gelu", norm_eps=1e-5,
    cross=CrossAttnConfig(every_k=1, n_context_tokens=1500, context_dim=0),
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, act="gelu", norm_eps=1e-5,
        cross=CrossAttnConfig(every_k=1, n_context_tokens=16, context_dim=0))
