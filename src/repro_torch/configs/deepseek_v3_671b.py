"""deepseek-v3-671b [moe] — 61L d=7168 128H MLA d_ff(expert)=2048
vocab=129280, 1 shared + 256 routed top-8, first 3 layers dense (d_ff 18432),
MTP head, the counterpart of ``repro/configs/deepseek_v3_671b.py``.
[arXiv:2412.19437; hf]"""
from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=2048,
    vocab=129280, rope_theta=10000.0, mtp_depth=1,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, d_ff_shared=2048,
                  first_k_dense=3, d_ff_dense=18432),
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab=256, mtp_depth=1,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96,
                      n_shared_experts=1, d_ff_shared=96,
                      first_k_dense=1, d_ff_dense=128))
