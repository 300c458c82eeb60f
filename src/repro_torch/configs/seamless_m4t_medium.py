"""seamless-m4t-medium: enc-dec, multimodal [arXiv:2308.11596; hf].
12 encoder + 12 decoder layers; audio frontend stubbed (precomputed frame
embeddings via input_specs())."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless_m4t_medium", family="audio", num_layers=12, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=256206,
    encoder_layers=12, frontend="audio", frontend_tokens=1024,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, encoder_layers=2, frontend_tokens=16)
