"""zamba2-7b: Mamba2 backbone + ONE shared attention block applied
periodically [arXiv:2411.15242; unverified].  81 layers, shared attn every 6.
"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2_7b", family="hybrid", num_layers=81, d_model=3584,
    num_heads=32, num_kv_heads=32, d_ff=14336, vocab_size=32000,
    ssm_kind="mamba2", ssm_state=64, hybrid_attn_every=6,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, ssm_state=16, hybrid_attn_every=2)
