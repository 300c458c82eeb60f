"""rwkv6-3b (Finch): attention-free, data-dependent decay [arXiv:2404.05892; hf].

The paper's KDE-attention technique is inapplicable here (no kernel matrix
is formed; see DESIGN.md §8) -- implemented without it.
"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6_3b", family="ssm", num_layers=32, d_model=2560,
    num_heads=40, num_kv_heads=40, d_ff=8960, vocab_size=65536,
    ssm_kind="rwkv6", ssm_state=64, head_dim=64,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
        head_dim=32, d_ff=128, vocab_size=256, ssm_state=32)
