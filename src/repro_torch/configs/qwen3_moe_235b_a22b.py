"""qwen3-moe-235b-a22b: 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_moe_235b_a22b", family="moe", num_layers=94, d_model=4096,
    num_heads=64, num_kv_heads=4, d_ff=1536, vocab_size=151936,
    head_dim=128, num_experts=128, experts_per_token=8, tie_embeddings=False,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=256, num_experts=8,
        experts_per_token=2)
