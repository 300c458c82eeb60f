"""granite-moe-1b-a400m: 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite_moe_1b_a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, d_ff=512, vocab_size=49155,
    num_experts=32, experts_per_token=8,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=255, num_experts=4, experts_per_token=2)
