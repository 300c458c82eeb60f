"""chatglm3-6b: GQA kv=2, 2d (half-dim) RoPE [arXiv:2406.12793; hf]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3_6b", family="dense", num_layers=28, d_model=4096,
    num_heads=32, num_kv_heads=2, d_ff=13696, vocab_size=65024,
    rope_style="glm2d",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256)
